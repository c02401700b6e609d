"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload d0_serve_b32 --seconds 2 \
        --seeds 11 12 13 --controls fp8 bf16 --out benchmark/out/x.jsonl

For each seed, in one process: the cell's run as ``run.py`` makes it (a
short window of ``--seconds``), the program's numbers against the
reference (the lower readings), then each named control in the program's
place against the same reference: ``fp8`` (the reference computed with
float8 products, the precision below the configuration's bf16, which has
to fail) and ``bf16`` (for comparison with the program). One JSON line
per seed goes to ``--out`` and to standard output.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import numpy as np  # noqa: E402

from run import caches  # noqa: E402


def save_dump(path: str, dump) -> None:
    """The judged lists, compactly: per image the reference's list once
    and each judged list, their valid detections' scores, boxes (float16)
    and classes, under ``<entry>_<image>_<label>[_<n>]_<field>``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {}
    for label, (j, i), served, ref in dump:
        for name, d in (("ref", ref), (label, served)):
            tag, n = f"{j}_{i}_{name}", 1
            if name == "ref" and f"{tag}_scores" in arrays:
                continue
            while f"{tag}_scores" in arrays:
                tag, n = f"{j}_{i}_{name}_{n}", n + 1
            v = d["valid"].astype(bool)
            arrays[f"{tag}_scores"] = d["scores"][v].astype(np.float32)
            arrays[f"{tag}_boxes"] = d["boxes"][v].astype(np.float16)
            arrays[f"{tag}_classes"] = d["classes"][v].astype(np.int16)
    np.savez_compressed(path, **arrays)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", nargs="*", default=["fp8"])
    p.add_argument("--out", default=None)
    p.add_argument("--dump", default=None,
                   help="a directory: each seed's judged detection lists "
                        "(program, controls, reference) as .npz")
    args = p.parse_args()
    caches()
    import torch
    from harness import cell
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        r = cell.execute(args.workload, seed, args.seconds, False, dev, t,
                         controls=args.controls, dump=bool(args.dump))
        line = {"workload": args.workload, "seed": seed,
                "program": r.checks, "controls": r.control_readings,
                "judged": r.judged, "failed": r.failed, "notes": r.notes,
                "metrics": r.metrics, "seconds": time.perf_counter() - t,
                "card": cell.power_limit()}
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        if args.dump and r.dump:
            save_dump(os.path.join(args.dump, f"{args.workload}_{seed}.npz"),
                      r.dump)
        del r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    loaded = cell.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
