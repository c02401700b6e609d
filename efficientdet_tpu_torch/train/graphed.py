"""The serving step as CUDA graphs: ``graphed_eval_step``.

Counterpart of the ``jax.jit(make_eval_step(...))`` that the JAX package's
serving entry points apply (``eval.py``, ``demo.py``, ``bench.py``,
``efficientdet_tpu/parallel/mesh.py::shard_eval_step``): jit compiles the
step once per input shape and then serves that one program, the NMS
Pallas kernel (and, where enabled, the fusion and MBConv kernels) inside
it. Here the eager step's device work, every hand-written kernel
included, is captured once per (shape, dtype, device) of the images as a
``torch.cuda.CUDAGraph`` and replayed, so a step costs the host one
replay instead of the ~1,000 launches the eager step issues from Python.

On CUDA images, the first call at a new shape runs the eager step
``WARMUP`` times on a side stream (what must not happen during a capture
happens there: ``nvcc`` builds the kernel library, Triton compiles the
fusion kernels, cuDNN and cuBLAS set up, the cached host constants reach
the card), captures it under ``torch.inference_mode()`` into a graph that
reads a static copy of the images, replays it once, synchronizes, and
raises unless that replay's detections equal the last eager step's. Every
call copies the images into the static buffer, replays the shape's graph
and returns clones of its outputs, so one call's detections never change
under the next, as jit returns fresh arrays. All graphs of one wrapper
share one memory pool (``torch.cuda.graph_pool_handle``). A capture or a
replay that fails raises; nothing falls back to the eager step.

CPU images go through the eager step unchanged (the caller asked for the
CPU, as the tests do).

Weights: a graph reads the parameters' and buffers' own storage, so what
changes them in place (``load_state_dict``, an optimizer step, BatchNorm's
running statistics) is seen by the next replay. A model whose tensors were
replaced since the capture (a new ``nn.Parameter`` assigned, ``.data =``,
``.to()`` into another layout or type) is refused with ``ValueError``: the
graph would read the old storage. Mode: a replay serves what was captured,
which is eval mode (JAX's ``train=False``), whatever mode the modules are
in when it runs.

Spans (``utils/tracing.py``): a call opens ``graph.check``,
``serve.stage`` (the copy into the static images), ``graph.replay`` and
``graph.clone``; a capture opens ``graph.record`` over ``graph.warmup``,
``graph.capture`` and ``graph.verify``.

Launch counts: a capture launches nothing, so the ``.launches`` counters
of the kernel wrappers (``kernels.KERNELS``) are set back to their values
before it, and each replay adds to each counter what the capture added to
it (the kernels the graph launches). The ``WARMUP`` eager steps of a
capture count as the launches they are.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from .. import kernels
from ..ops.nms import Detections
from ..utils import tracing

# Eager steps run at each new shape before its capture.
WARMUP = 3


class Graph(NamedTuple):
    """One captured step: its graph, the static images it reads, the
    static detections it writes, each wrapper's launches per replay, and
    the model's tensor storage it was captured on."""

    graph: "torch.cuda.CUDAGraph"
    images: torch.Tensor
    detections: Detections
    launches: Tuple[Tuple[Callable, int], ...]
    storage: Tuple[int, ...]


def _on_card(images: torch.Tensor) -> bool:
    return images.device.type == "cuda"


def _capture(graph, fn: Callable[[], Detections], pool, stream) -> Detections:
    """``fn()`` captured into ``graph`` on ``stream``, allocating from
    ``pool``; returns its outputs, which the graph's replays overwrite."""
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        return fn()


class GraphedEvalStep:
    """``make_eval_step``'s step, served from one CUDA graph per (shape,
    dtype, device) of CUDA images (the module docstring). ``graphs`` maps
    each such key to its ``Graph``; ``model`` is the step's model; ``pool``
    the graphs' memory pool (None before the first capture)."""

    def __init__(self, eval_step: Callable[[torch.Tensor], Detections]):
        model = getattr(eval_step, "model", None)
        if model is None:
            raise ValueError("graphed_eval_step needs make_eval_step's step "
                             "(a callable with .model)")
        self.eval_step = eval_step
        self.model = model
        self.graphs: Dict[tuple, Graph] = {}
        self.pool = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        # The dictionaries that hold the model's tensors and their keys,
        # taken at the first capture: reading a tensor's storage through
        # them sees a replaced tensor as well as a moved one.
        self._slots = None

    def __call__(self, images: torch.Tensor) -> Detections:
        if not _on_card(images):
            return self.eval_step(images)
        if self.model.spatial is not None:
            raise ValueError(
                "graphed_eval_step: the model is bound to the spatial axis "
                "(parallel.shard_eval_step); its halo exchanges go through "
                "gloo on the host and cannot be captured in a CUDA graph, so "
                "serve it with make_eval_step's eager step")
        if images.requires_grad:
            raise ValueError("graphed_eval_step: the images require a "
                             "gradient; the serving step has no backward")
        key = (tuple(images.shape), images.dtype, images.device)
        with torch.inference_mode():
            entry = self.graphs.get(key)
            if entry is None:
                with tracing.span("graph.record"):
                    entry = self.graphs[key] = self._record(images)
            else:
                with tracing.span("graph.check"):
                    replaced = self._storage() != entry.storage
                if replaced:
                    raise ValueError(
                        f"graphed_eval_step: the model's parameters or "
                        f"buffers were replaced since the graph for images "
                        f"{key[0]} {key[1]} was captured, which would read "
                        f"the old ones; copy new weights in place "
                        f"(load_state_dict) or graph a new step")
                with tracing.span("serve.stage"):
                    entry.images.copy_(images)
                with tracing.span("graph.replay"):
                    _replay(entry)
            with tracing.span("graph.clone"):
                return Detections(*(t.clone() for t in entry.detections))

    def _storage(self) -> Tuple[int, ...]:
        return tuple(d[name].data_ptr() if d.get(name) is not None else 0
                     for d, name in self._slots)

    def _record(self, images: torch.Tensor) -> Graph:
        """Warm up, capture and replay once at ``images``' key; raises
        unless the replay equals the last eager step."""
        dev = images.device
        if self._slots is None:
            self._slots = [(d, name) for m in self.model.modules()
                           for d in (m._parameters, m._buffers)
                           for name, t in d.items() if t is not None]
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        stream = self._streams[dev]
        static = torch.empty(images.shape, dtype=images.dtype, device=dev)
        static.copy_(images)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with tracing.span("graph.warmup"), torch.cuda.stream(stream):
            for _ in range(WARMUP):
                want = self.eval_step(static)
        torch.cuda.current_stream(dev).wait_stream(stream)

        counted = kernels.KERNELS
        before = [fn.launches for fn in counted]
        graph = torch.cuda.CUDAGraph()
        try:
            with tracing.span("graph.capture"):
                out = _capture(graph, lambda: self.eval_step(static),
                               self.pool, stream)
        finally:
            added = [fn.launches - n for fn, n in zip(counted, before)]
            for fn, n in zip(counted, before):
                fn.launches = n
        entry = Graph(graph, static, Detections(*out),
                      tuple((fn, n) for fn, n in zip(counted, added) if n),
                      self._storage())
        with tracing.span("graph.verify"):
            _replay(entry)
            torch.cuda.synchronize(dev)
            differ = [f for f, a, b in zip(Detections._fields,
                                           entry.detections, want)
                      if not torch.equal(a, b)]
        if differ:
            raise RuntimeError(
                f"graphed_eval_step: the first replay of the graph for "
                f"images {tuple(images.shape)} {images.dtype} differs from "
                f"the eager step in {', '.join(differ)}")
        return entry


def _replay(entry: Graph) -> None:
    entry.graph.replay()
    for fn, n in entry.launches:
        fn.launches += n


def graphed_eval_step(eval_step: Callable[[torch.Tensor], Detections]
                      ) -> GraphedEvalStep:
    """``eval_step`` (``make_eval_step``'s) served from CUDA graphs on the
    card and eagerly on the CPU: the port's ``jax.jit(eval_step)``. A
    step that is graphed already is returned as it is."""
    if isinstance(eval_step, GraphedEvalStep):
        return eval_step
    return GraphedEvalStep(eval_step)


__all__ = ["WARMUP", "Graph", "GraphedEvalStep",
           "graphed_eval_step"]
