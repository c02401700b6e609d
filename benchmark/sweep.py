"""The highest request rate a serving cell sustains, by a sweep on the card.

    python3 benchmark/sweep.py --workload d0_serve_b1 --seconds 10 \
        --rates 200 250 280 300 320 340

Runs the cell's loop once per rate, with the cell's own arrivals (the
mix's ``rate_per_s`` replaced), in one process, and prints one JSON line
per rate: the p95 latency, the rate served and the longest a request
waited for the server. A rate the system sustains serves all it is offered
with a flat queue.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from run import caches  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args()
    caches()
    import torch
    from harness import cell, spec
    bench = spec.benchmark()
    mix = spec.traffic(spec.workload(bench, args.workload)["traffic"])
    for rate in args.rates:
        r = cell.execute(args.workload, args.seed, args.seconds, False,
                         torch.device("cuda", 0), time.perf_counter(),
                         bench=bench, mix=dict(mix, rate_per_s=rate))
        print(json.dumps({"rate_per_s": rate, "attempted": r.attempted,
                          "served_per_s": r.metrics["serve_img_s"]
                          / mix["batch"],
                          "serve_p95_ms": r.metrics["serve_p95_ms"],
                          **r.notes, "card": cell.power_limit()}),
              flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
