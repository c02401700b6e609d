"""The host's own milliseconds per request: the part of each traced
request, from the hand-over of its image to its detections in host memory,
in which no device activity ran (the copy's staging, the graph's launch,
the clones, the copies back and the sync), averaged over the traced
requests. Time a request spends waiting for its due time or for the
server is not in it."""


def read(record):
    if not record.get("requests"):
        return None
    return 1e3 * record["request_idle_s"] / record["requests"]
