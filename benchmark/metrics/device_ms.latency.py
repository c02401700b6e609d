"""Device busy milliseconds per request: the union of device activity
(kernels and copies) over the traced requests, per request."""


def read(record):
    if not record["steps"] or record["busy_s"] <= 0:
        return None
    return 1e3 * record["busy_s"] / record["steps"]
