"""One run of one benchmark cell of ``efficientdet_tpu_torch`` on the card.

    python3 benchmark/run.py --workload d0_serve_b32 --seed 7 --seconds 20 \
        --trace 0

Run from the root of a checkout. The cell, its configuration, its traffic
mix, its limits and its per-layer metrics are found by name
(``BENCHMARK.json``, ``harness/spec.py``). The last line of standard output
is the result's JSON object; the numbers that decide ``correct``, each with
its limit, are also the last lines of standard error. Exits non-zero,
printing no result, without a card, without the program, or where the
JAX package or its stack was loaded. Kernel and compile caches stay in
``benchmark/.cache/`` at fixed paths.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

from harness.clock import process_start  # noqa: E402

T_START = process_start()


def caches() -> None:
    """Fixed cache directories inside the checkout, for every compiler the
    program may start."""
    base = os.path.join(HERE, ".cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "efficientdet_tpu_torch")):
        print("the program (efficientdet_tpu_torch/) is not in this "
              "checkout", file=sys.stderr)
        return 2
    caches()
    import torch
    from harness import cell, spec
    bench = spec.benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    r = cell.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START, bench=bench)
    loaded = cell.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    out = cell.result(r, bench)
    for e in r.errors:
        print(e, file=sys.stderr)
    for k, v in r.notes.items():
        print(f"{k}: {v}", file=sys.stderr)
    print(f"readings: {json.dumps(r.checks)}", file=sys.stderr)
    print(f"judged {r.judged} outputs; correct={out['correct']}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
