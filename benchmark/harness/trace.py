"""The traced run's reduction: from a ``torch.profiler`` trace of a bounded
number of the window's steps to the record that the per-layer metric
readers take.

``busy_intervals`` is the union of device activity (kernels and copies
alike), copied from the port's card script (``chip_smoke.py::busy_ms``).
The traced steps sit inside one ``record_function`` span
(``WINDOW_SPAN``), whose length, on the profiler's clock, is the traced
window; idle gaps are the parts of it that no device activity covers,
each named by the innermost host event that was running at its middle.
Each request sits in a ``REQUEST_SPAN``, from the hand-over of its input
to its answer in host memory; the part of it that no device activity
covers is the host's own work on the request (``request_idle_s``).
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

WINDOW_SPAN = "bench.traced_window"
REQUEST_SPAN = "bench.request"

Interval = Tuple[float, float]


def busy_intervals(intervals: List[Interval]) -> List[Interval]:
    """The union of the intervals, merged and sorted."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def uncovered(span: Interval, merged: List[Interval],
              starts: List[float]) -> float:
    """The part of ``span`` that the sorted, disjoint ``merged`` intervals
    (``starts`` their starts) leave uncovered."""
    s, e = span
    covered = 0.0
    k = max(0, bisect.bisect_right(starts, s) - 1)
    while k < len(merged) and merged[k][0] < e:
        covered += max(0.0, min(e, merged[k][1]) - max(s, merged[k][0]))
        k += 1
    return (e - s) - covered


def reduce_events(device: List[Tuple[str, float, float]],
                  host: List[Tuple[str, float, float]], steps: int,
                  images: int) -> Dict:
    """Device and host events (name, start us, end us) of one trace ->
    the record: ``steps`` and ``images`` traced, ``window_s`` (the
    ``WINDOW_SPAN``'s length), ``busy_s`` (device union inside it),
    ``device_ops`` {name: seconds}, ``device_ops_top`` and ``idle_gaps``
    ([name, seconds], at most 10 each, largest first), ``requests`` (the
    ``REQUEST_SPAN``s inside the window) and ``request_idle_s`` (the part
    of them that no device activity covers)."""
    spans = [(s, e) for n, s, e in host if n == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = spans[0]
    inside = [(max(s, w0), min(e, w1)) for _, s, e in device
              if e > w0 and s < w1]
    merged = busy_intervals(inside)
    busy = sum(e - s for s, e in merged)
    ops: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in device:
        if e > w0 and s < w1:
            ops[n] += (min(e, w1) - max(s, w0)) / 1e6
    gaps = []
    at = w0
    for s, e in merged + [(w1, w1)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    starts = [s for s, _ in merged]
    requests = [(s, e) for n, s, e in host
                if n == REQUEST_SPAN and s >= w0 and e <= w1]
    request_idle = sum(uncovered(q, merged, starts) for q in requests)
    named: Dict[str, float] = collections.defaultdict(float)
    inner = sorted(((s, e, n) for n, s, e in host if n != WINDOW_SPAN),
                   key=lambda x: x[0])
    active: List[Tuple[float, float, str]] = []
    nxt = 0
    for s, e in gaps:   # in time order: sweep the host events once
        mid = (s + e) / 2
        while nxt < len(inner) and inner[nxt][0] <= mid:
            active.append(inner[nxt])
            nxt += 1
        active = [a for a in active if a[1] >= mid]
        name = (min(active, key=lambda a: a[1] - a[0])[2] if active
                else "(no host event)")
        named[name] += (e - s) / 1e6
    return {
        "steps": steps, "images": images, "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6, "device_ops": dict(ops),
        "requests": len(requests), "request_idle_s": request_idle / 1e6,
        "device_ops_top": sorted(([n, t] for n, t in ops.items()),
                                 key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, t] for n, t in named.items()),
                            key=lambda x: -x[1])[:10]}


def reduce_profile(prof, steps: int, images: int) -> Dict:
    """``reduce_events`` over a finished ``torch.profiler.profile``."""
    import torch
    device, host = [], []
    for ev in prof.events():
        item = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # The spans are drawn on the device's timeline too; no work.
            if ev.name not in (WINDOW_SPAN, REQUEST_SPAN):
                device.append(item)
        else:
            host.append(item)
    return reduce_events(device, host, steps, images)
