"""One run of one cell: what it was given and what it measured.

Set-up time runs from the process's own start (``process_start``, read
from ``/proc`` before anything heavy is imported) to the first timed
request. At its end, what set-up left alive is collected and frozen
(``gc.freeze``), so that the window's collections scan only what the
window makes; the window's collections and the times the host took the
process off its core are noted (``window_closed``).

The traced run (``--trace 1``) profiles ``trace_requests`` of the window's
requests, from the first that starts a lead time into the window, inside
one ``trace.WINDOW_SPAN``, each request inside a ``trace.REQUEST_SPAN``;
the reduction runs after the window has closed.
"""

from __future__ import annotations

import contextlib
import gc
import resource
import time
import traceback
from typing import ContextManager, Dict, Optional, Sequence

import torch

from . import spec
from . import trace as trace_lib

# Seconds into the window before the traced requests start.
TRACE_LEAD_S = 1.0


class Run:
    def __init__(self, workload: str, cfg: Dict, mix: Dict, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 t_start: float, controls: Sequence[str] = (),
                 bench_dir: Optional[str] = None):
        self.workload, self.cfg, self.mix = workload, cfg, mix
        self.bench_dir = bench_dir or spec.BENCH_DIR
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.controls = tuple(controls)
        self.metrics: Dict[str, float] = {}
        self.checks: Dict[str, float] = {}
        self.control_readings: Dict[str, Dict[str, float]] = {}
        self.attempted = 0
        self.failed = 0
        self.judged = 0
        self.errors = []
        self.notes: Dict = {}
        self.dump: Optional[list] = None
        self.setup_s: Optional[float] = None
        self.memory_peak: Optional[int] = None
        self.record: Optional[Dict] = None
        self._prof = None
        self._span = None
        self._first = None
        self._traced = None
        self._pauses: list = []
        self._gc_t = 0.0
        self._rusage = None

    def setup_done(self) -> None:
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start
        self.metrics["setup_s"] = self.setup_s
        gc.callbacks.append(self._gc_event)
        self._rusage = resource.getrusage(resource.RUSAGE_SELF)

    def _gc_event(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self._pauses.append(time.perf_counter() - self._gc_t)

    def window_closed(self) -> None:
        """Notes the window's garbage collections and involuntary context
        switches, and unfreezes what set-up left alive. Once a run."""
        if self._rusage is None or self._gc_event not in gc.callbacks:
            return
        gc.callbacks.remove(self._gc_event)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.notes["gc_in_window"] = (
            f"{len(self._pauses)} collections, longest "
            f"{max(self._pauses, default=0.0) * 1e3:.3f} ms")
        self.notes["preempted_in_window"] = (ru.ru_nivcsw
                                             - self._rusage.ru_nivcsw)
        gc.unfreeze()

    def fail(self, e: BaseException) -> None:
        self.failed += 1
        if len(self.errors) < 3:
            self.errors.append("".join(traceback.format_exception(e)))

    def read_memory(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = max(
                torch.cuda.max_memory_allocated(d)
                for d in range(torch.cuda.device_count()))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the traced requests
    def request_span(self) -> ContextManager:
        """The span of one request, while the profiler records."""
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(trace_lib.REQUEST_SPAN)

    def maybe_start_trace(self, i: int, t0: float) -> None:
        if (not self.trace or self._prof is not None
                or self._traced is not None
                or time.perf_counter() < t0 + TRACE_LEAD_S):
            return
        self.sync()
        self._prof = _profiler()
        self._prof.start()
        self._span = torch.profiler.record_function(trace_lib.WINDOW_SPAN)
        self._span.__enter__()
        self._first = i

    def maybe_stop_trace(self, i: int, images_per_step: int,
                         force: bool = False) -> None:
        if self._prof is None:
            return
        steps = i - self._first
        if steps < self.mix["trace_requests"] and not force:
            return
        self.sync()
        self._span.__exit__(None, None, None)
        self._prof.stop()
        self._traced = (self._prof, steps, steps * images_per_step)
        self._prof = None

    def finish_trace(self, i: Optional[int] = None,
                     images_per_step: int = 0) -> None:
        """Stops a trace the window's end cut short, then reduces it."""
        if self._prof is not None:
            self.maybe_stop_trace(i, images_per_step, force=True)
        if self._traced is not None:
            prof, steps, images = self._traced
            self.record = trace_lib.reduce_profile(prof, steps, images)
            self.record.update(cfg=self.cfg, mix=self.mix)
            self._traced = None


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@contextlib.contextmanager
def profiled(r: Run):
    """A throwaway trace in set-up, so that the window's trace does not pay
    the profiler's first start."""
    prof = _profiler()
    prof.start()
    try:
        yield
    finally:
        r.sync()
        prof.stop()
