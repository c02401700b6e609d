"""The port's spans: named host intervals around the work of its layers.

    from efficientdet_tpu_torch.utils import tracing

    tracing.enable()
    evaluator.eval_fn(images)          # records serve.eval_fn, serve.stage...
    out = tracing.drain()              # {'spans', 'summary', 'counters'}
    tracing.disable()

``span(name)`` is a context manager placed where a layer's work begins
and ends. Off (the default) it reads one module flag and returns a shared
no-op: no clock is read, nothing is allocated and no profiler range is
entered. On, it records a ``Span`` (name, start and end from
``time.perf_counter_ns()``, the enclosing span's id on this thread, and the
request: the id shared by every span under one top-level span, a serving
call or a training step). While a ``torch.profiler`` records, each span
also enters a profiler range of its own name, so the span sits on the
device trace's clock and a trace names the idle gaps and the kernels'
launches under it. The range is ``record_function``'s lean form
(``_RecordFunctionFast``): a fraction of a microsecond where
``record_function`` takes several, on the profiler's clock within a few
microseconds, and drawn on the host's timeline only, so that a trace's
device activity holds no span. Replayed CUDA graphs run no Python, so the
kernels of a replay sit under ``graph.replay`` and under no ``model.*``
span.

``drain()`` hands back the spans closed so far (and forgets them), a
summary per name (count, wall seconds, self seconds: the wall less the
walls of the spans directly under it) and the kernel wrappers' own
``.launches`` counters (``train.graphed.COUNTED``) as ``kernel.<name>``,
read as they stand: launches are counted there and only there.

``SPANS`` names every span the package opens; with tracing on, any other
name raises, so this tuple and the table of spans in ``PERF.md`` can be
held against each other.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

SPANS = (
    # The eval entry point's request, and the staging of its images on
    # the card (the host batch's copy and the graph's static input copy).
    "serve.eval_fn", "serve.stage",
    # The serving step served from a CUDA graph (train/graphed.py): the
    # check of the model's storage, the replay, the outputs' clones, and
    # a capture with its warm-up steps, the capture and its check.
    "graph.check", "graph.replay", "graph.clone",
    "graph.record", "graph.warmup", "graph.capture", "graph.verify",
    # Set-up of the eval entry point and the demo.
    "setup.build", "setup.load_weights",
    # The model's forwards (eager steps only), and the serving tail.
    "model.backbone", "model.bifpn", "model.head", "serve.postprocess",
    # The training driver's step and the train step's parts.
    "train.step", "train.data_wait", "train.forward_loss", "train.backward",
    "train.reduce", "train.apply",
)
_KNOWN = frozenset(SPANS)

_on = False
_closed: List["Span"] = []
_ids = itertools.count()
_requests = itertools.count()
_local = threading.local()


class Span(NamedTuple):
    """One closed span: ``parent`` is the id of the span it ran in (None
    for a top-level span), ``request`` the id its top-level span opened."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: int
    id: int


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "id", "parent", "request", "start", "range")

    def __init__(self, name: str):
        if name not in _KNOWN:
            raise ValueError(f"tracing: no span {name!r} in tracing.SPANS")
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, next(_requests)
        self.id = next(_ids)
        stack.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _local.stack.pop()
        _closed.append(Span(self.name, self.start, end, self.parent,
                            self.request, self.id))
        return False


def span(name: str):
    """The span ``name`` (one of ``SPANS``) around a ``with`` block."""
    if not _on:
        return _OFF
    return _On(name)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def summarize(spans: List[Span]) -> Dict[str, Dict[str, float]]:
    """{name: {'count', 'wall_s', 'self_s'}} over ``spans``; a span's self
    time is its wall less the walls of the spans among ``spans`` directly
    under it."""
    children: Dict[int, int] = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = (children.get(s.parent, 0)
                                  + s.end_ns - s.start_ns)
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        wall = s.end_ns - s.start_ns
        row = out.setdefault(s.name, {"count": 0, "wall_s": 0.0,
                                      "self_s": 0.0})
        row["count"] += 1
        row["wall_s"] += wall / 1e9
        row["self_s"] += (wall - children.get(s.id, 0)) / 1e9
    return out


def drain() -> Dict:
    """{'spans': the spans closed since the last drain, in order of their
    start; 'summary': ``summarize`` of them; 'counters': {'kernel.<name>':
    that wrapper's ``.launches``}}. Forgets the spans."""
    global _closed
    from ..train import graphed
    spans, _closed = _closed, []
    spans.sort(key=lambda s: s.start_ns)
    return {"spans": spans, "summary": summarize(spans),
            "counters": {f"kernel.{fn.__name__}": fn.launches
                         for fn in graphed.COUNTED}}


__all__ = ["SPANS", "Span", "disable", "drain", "enable", "span", "summarize"]
