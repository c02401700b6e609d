"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration, whose file
``configs`` gives, and its traffic mix, ``traffic/<traffic>.json``; its
correctness limits are ``limits/<cell>.json``; each per-layer metric is a
reader ``metrics/<metric>.py`` with a function ``read(record)``. A mix
names the code it runs by kind, each a module found the same way
(``module``): its loop, ``loops/<loop>.py`` with ``run(r)``; its images,
``images/<images>.py`` with ``pool(mix, cfg, seed, device)``; and, for
requests that come due at given times, ``arrivals/<arrivals>.py`` with
``times(mix, seconds)``. A later change adds a configuration, a mix, a
loop, a source of images or arrivals, a cell or a metric by adding its
file and its entry: no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: Dict, name: str, root: str = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> Dict:
    return load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def limits(cell: str, bench_dir: str = BENCH_DIR
           ) -> Dict[str, Optional[float]]:
    return load_json(os.path.join(bench_dir, "limits", f"{cell}.json"))


def _for_cell(entry: Dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if _for_cell(m, cell)]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    moves = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moves)]


def module(kind: str, name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """``<bench_dir>/<kind>/<name>.py``, loaded."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} {name!r}: {path} is missing")
    tag = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(tag, path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(name: str, bench_dir: str = BENCH_DIR
           ) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    return module("metrics", name, bench_dir).read
