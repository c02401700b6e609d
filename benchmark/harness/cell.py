"""One run of one cell, from ``BENCHMARK.json`` to the result's line.

``execute`` looks up the cell, its configuration, its mix and its limits
by name, runs the mix's loop (``loops/<loop>.py``, found by name), and
builds the result: with ``trace`` off the cell's end-to-end metrics,
with it on the cell's per-layer metrics, each read by its own reader
(``metrics/<name>.py``) from the traced record; a reader that finds
nothing to read returns None and its metric is left out.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, Optional, Sequence

import torch

from . import check, spec
from .run_state import Run

# Top-level modules the run may not hold (the JAX package and its stack).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "efficientdet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float,
            controls: Sequence[str] = (), bench: Optional[Dict] = None,
            cfg: Optional[Dict] = None, mix: Optional[Dict] = None,
            dump: bool = False, bench_dir: str = spec.BENCH_DIR) -> Run:
    """Runs the cell once into a ``Run``. ``cfg`` and ``mix`` replace the
    cell's configuration and mix (the tests' small sizes); ``controls``
    also reads the controls the loop knows by name; ``bench_dir`` is the
    directory the mix, its modules and the limits are found in."""
    bench = bench or spec.benchmark()
    w = spec.workload(bench, workload)
    cfg = cfg or spec.config(bench, w["config"])
    mix = mix or spec.traffic(w["traffic"], bench_dir)
    r = Run(workload, cfg, mix, seed, seconds, trace, device, t_start,
            controls, bench_dir)
    if dump:
        r.dump = []
    try:
        spec.module("loops", mix["loop"], bench_dir).run(r)
    finally:
        r.window_closed()
    return r


def result(r: Run, bench: Optional[Dict] = None) -> Dict:
    """The result's JSON object; ``checks`` comes last."""
    bench = bench or spec.benchmark()
    limits = spec.limits(r.workload, r.bench_dir)
    ok, checks = check.judge(r.checks, limits)
    correct = ok and r.failed == 0 and r.judged > 0
    metrics = {}
    if not r.trace:
        for m in spec.end_to_end(bench, r.workload):
            if m["name"] in r.metrics:
                metrics[m["name"]] = {"value": r.metrics[m["name"]],
                                      "unit": m["unit"]}
    elif r.record is not None:
        for m in spec.per_layer(bench, r.workload):
            value = spec.reader(m["name"], r.bench_dir)(r.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = r.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(r.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": r.memory_peak or 0}
    if cuda:
        device["power_limit"] = power_limit()
    out = {"correct": correct, "attempted": r.attempted, "failed": r.failed,
           "metrics": metrics, "device": device}
    if r.trace and r.record is not None:
        device["busy_s"] = r.record["busy_s"]
        device["window_s"] = r.record["window_s"]
        out["breakdown"] = {"device_ops": r.record["device_ops_top"],
                            "idle_gaps": r.record["idle_gaps"]}
    out["checks"] = checks
    return out
