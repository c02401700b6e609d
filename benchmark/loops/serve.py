"""The serving loop: one client of the eval entry point. Without
``arrivals`` in the mix the loop is closed: the client hands over a host
batch, waits for its detections in host memory and hands over the next (a
dataset scored offline: every request is there from the start). With
them, requests come due at the mix's arrival times, whatever the server's
pace, wait in order for the one server, and each is timed from when it
was due.

Set-up captures the one graph the cell's shape needs. Every request of
the window is judged against the reference once the window has closed.
"""

import os
import time
from typing import Dict, List

import numpy as np

from harness import serve, traffic
from harness.run_state import profiled


def run(r) -> None:
    """Set-up, window and judgement of one serving run into ``r``."""
    cfg, mix = r.cfg, r.mix
    b = mix["batch"]
    state = serve.seeded_state(cfg, r.seed, r.device)
    path = serve.weights_file(state)
    try:
        ev = serve.evaluator(cfg, b, path, r.device.type)
    finally:
        os.remove(path)
    pool = traffic.image_pool(r)
    due = traffic.arrival_times(r)
    for _ in range(2):            # captures the cell's one graph
        serve.request(ev.eval_fn, pool[0])
    if r.trace:
        with profiled(r):         # the profiler's own first start
            serve.request(ev.eval_fn, pool[0])
    if r.device.type == "cuda":
        r.notes["h2d_pageable_gb_s"] = serve.copy_rate(pool[0], r.device)
    r.setup_done()

    outputs: List[Dict[bytes, list]] = [{} for _ in pool]
    latencies, service = [], []
    waited = 0.0
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + r.seconds
    t_last = t0
    while True:
        if due is None:
            t_in = time.perf_counter()
            if t_in >= deadline:
                break
        else:
            if i >= len(due):
                break
            t_in = t0 + due[i]
            serve.wait_until(t_in)
            waited = max(waited, time.perf_counter() - t_in)
        j = i % len(pool)
        r.maybe_start_trace(i, t0)
        t_call = time.perf_counter()
        try:
            with r.request_span():
                out = serve.request(ev.eval_fn, pool[j])
        except Exception as e:  # noqa: BLE001 -- a failed request is counted
            r.fail(e)
            out = None
        t_last = time.perf_counter()
        service.append(t_last - t_call)
        latencies.append(t_last - t_in if out is not None else None)
        if out is not None:
            slot = outputs[j].setdefault(serve.digest(out), [out, 0])
            slot[1] += 1
        i += 1
        r.maybe_stop_trace(i, b)
    r.window_closed()
    r.finish_trace(i, b)
    window = t_last - t0
    r.attempted = i
    if due is not None:
        # The longest that a due request waited for the one server.
        r.notes["queue_wait_max_ms"] = float(waited) * 1e3
    r.notes["service_ms_p50_p99_max"] = [
        float(v) * 1e3 for v in (*np.percentile(service, [50, 99]),
                                 max(service, default=0.0))]
    lat = np.array([x if x is not None else window for x in latencies])
    r.metrics["serve_img_s"] = (i - r.failed) * b / window
    r.metrics["serve_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    del ev
    serve.judge_window(r, state, pool, outputs)
