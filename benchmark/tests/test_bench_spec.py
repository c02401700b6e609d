"""The benchmark is driven by data: every name in BENCHMARK.json finds its
file, and the counts the yardstick divides by are right."""

import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import BENCH, small_cfg
from harness import (bounds, cell, flops, geometry, readers, spec, trace,
                     traffic)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    return spec.benchmark()


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                      "device_trace")
    for w in b["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_by_name(name):
    """Configuration, mix, limits and every per-layer reader of the cell
    load by name; every per-layer metric moves an end-to-end metric the
    cell reports; the cell reports setup_s and one more."""
    b = bench()
    w = spec.workload(b, name)
    cfg = spec.config(b, w["config"])
    mix = spec.traffic(w["traffic"])
    assert callable(spec.module("loops", mix["loop"]).run)
    assert callable(spec.module("images", mix["images"]).pool)
    if "arrivals" in mix:
        assert callable(spec.module("arrivals", mix["arrivals"]).times)
    assert cfg["input_size"] > 0 and mix["batch"] > 0
    assert set(spec.limits(name))
    e2e = {m["name"] for m in spec.end_to_end(b, name)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(b, name)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))


def test_new_entries_need_no_edit(tmp_path):
    """A cell added as data (an entry and its files) is found without an
    edit to a harness file: spec reads names, not a list of its own."""
    b = bench()
    b["workloads"].append({"name": "d0_serve_b8", "config": "d0",
                           "traffic": "serve_closed_b32", "chips": 1,
                           "why": "x"})
    assert spec.workload(b, "d0_serve_b8")["config"] == "d0"
    assert spec.end_to_end(b, "d0_serve_b8") == [
        m for m in b["end_to_end"] if "workloads" not in m]


def _write(root, files):
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)


def test_new_mix_modules_need_no_edit(tmp_path):
    """A mix that names a loop, a source of images and a source of
    arrivals that the harness has never seen runs from files placed in
    another directory: nothing in the harness names them."""
    _write(tmp_path, {
        "traffic/bursts_b2.json": json.dumps(
            {"loop": "replay", "batch": 2, "pool": 3, "images": "ramp",
             "arrivals": "bursts", "burst": 4}),
        "images/ramp.py": (
            "import numpy as np\n"
            "def pool(mix, cfg, seed, device):\n"
            "    return [np.full((mix['batch'], 4, 4, 3), k, np.uint8)\n"
            "            for k in range(mix['pool'])]\n"),
        "arrivals/bursts.py": (
            "import numpy as np\n"
            "def times(mix, seconds):\n"
            "    return np.repeat([0.0, seconds], mix['burst'])\n"),
        "loops/replay.py": (
            "from harness import traffic\n"
            "def run(r):\n"
            "    pool, due = traffic.image_pool(r), traffic.arrival_times(r)\n"
            "    r.setup_done()\n"
            "    r.attempted = r.judged = len(due)\n"
            "    r.checks = {'ramp_sum': float(sum(p.sum() for p in pool))}"
            "\n"),
        "limits/d0_bursts.json": json.dumps({"ramp_sum": 288.0}),
    })
    b = bench()
    b["workloads"].append({"name": "d0_bursts", "config": "d0",
                           "traffic": "bursts_b2", "chips": 1, "why": "x"})
    r = cell.execute("d0_bursts", 2 ** 31 + 5, 0.1, False,
                     torch.device("cpu"), 0.0, bench=b,
                     bench_dir=str(tmp_path))
    out = cell.result(r, b)
    assert r.attempted == 8 and out["checks"]["ramp_sum"]["value"] == 288.0
    assert out["correct"] is True and set(out["metrics"]) == {"setup_s"}


def test_new_arrivals_drive_the_serving_loop(tmp_path):
    """The serving loop takes a kind of arrivals it has never seen (a
    Poisson stream) from a file of its own, and the run is judged as
    the cell's are."""
    _write(tmp_path, {
        "traffic/poisson_b1.json": json.dumps(
            {"loop": "serve", "batch": 1, "pool": 2,
             "images": "uniform_uint8", "arrivals": "poisson",
             "rate_per_s": 20}),
        "arrivals/poisson.py": (
            "import numpy as np\n"
            "def times(mix, seconds):\n"
            "    rng = np.random.default_rng(0)\n"
            "    n = int(mix['rate_per_s'] * seconds)\n"
            "    gaps = rng.exponential(1 / mix['rate_per_s'], n)\n"
            "    return np.cumsum(gaps)\n"),
    })
    for rel in ("loops/serve.py", "images/uniform_uint8.py",
                "limits/d0_serve_b1.json"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(open(os.path.join(BENCH, rel)).read())
    cfg = small_cfg()
    cfg["dtype"] = "float32"
    r = cell.execute("d0_serve_b1", 2 ** 31 + 6, 0.2, False,
                     torch.device("cpu"), 0.0, cfg=cfg,
                     bench_dir=str(tmp_path),
                     mix=spec.traffic("poisson_b1", str(tmp_path)))
    assert r.attempted == 4 and r.failed == 0 and r.judged >= 2
    assert cell.result(r)["correct"] is True


def test_configs_follow_their_sources():
    b = bench()
    d0 = spec.config(b, "d0")
    d7 = spec.config(b, "d7")
    assert [side for _, side in geometry.pyramid(d0)] == [64, 32, 16, 8, 4]
    assert [side for _, side in geometry.pyramid(d7)] == [204, 102, 51, 25,
                                                          12]
    assert geometry.num_anchors(d0) == 49104
    assert geometry.num_anchors(d7) == 498510
    assert [c for c, _ in geometry.pyramid(d0)] == [40, 80, 112, 192, 320]
    assert len(geometry.blocks(d0)) == 16 and len(geometry.blocks(d7)) == 45
    for c in b["configs"]:
        assert c["reduced"] == []


def test_head_flops_by_hand():
    """D0's head over P3..P7's 5,456 cells: two towers of a 64->256 and
    three 256->256 3x3 convs, the 720-channel class conv and the 36-channel
    box conv: ~30.4 GMAC an image."""
    d0 = spec.config(bench(), "d0")
    cells = 64 ** 2 + 32 ** 2 + 16 ** 2 + 8 ** 2 + 4 ** 2
    assert cells == 5456
    per_cell = (2 * (64 * 256 * 9 + 3 * 256 * 256 * 9) + 256 * 720 * 9
                + 256 * 36 * 9)
    macs = flops.conv_macs(d0)
    assert macs["head"] == cells * per_cell
    assert 30e9 < macs["head"] < 31e9
    assert flops.forward_flops(d0) == 2 * sum(macs.values())


def test_mbconv_bound_sum_matches_the_card_script():
    """Sum of mbconv_bound over D0's 15 expanded blocks at B=32: 0.1931 ms
    (the port's card script's figure), bytes-bound."""
    d0 = spec.config(bench(), "d0")
    shapes = geometry.mbconv_shapes(d0)
    assert len(shapes) == 15
    total = sum(bounds.mbconv_bound(s, 32)[0] for s in shapes)
    assert round(total, 4) == 0.1931


def synthetic_record(cfg, steps=4, batch=32):
    """Device work: 3 ms of ops in each 4 ms step, of it 0.5 ms in two
    MBConv kernels; the host copies through the 1 ms gap, the graph's
    launch ends it. Each request runs from 0.2 ms before its step's first
    kernel to 0.1 ms after its last."""
    dev, host = [], [(trace.WINDOW_SPAN, 0.0, steps * 4000.0)]
    for s in range(steps):
        t = s * 4000.0
        dev += [("mbconv_tc_kernel<64>", t, t + 400.0),
                ("se_mean_kernel", t + 400.0, t + 500.0),
                ("cudnn_conv", t + 450.0, t + 3000.0)]   # overlaps 50 us
        host.append(("aten::copy_", t + 3000.0, t + 3900.0))
        host.append(("cudaGraphLaunch", t + 3900.0, t + 4000.0))
        if s:
            host.append((trace.REQUEST_SPAN, t - 200.0, t + 3100.0))
    rec = trace.reduce_events(dev, host, steps, steps * batch)
    rec.update(cfg=cfg, mix={})
    return rec


def test_trace_reduction():
    rec = synthetic_record(spec.config(bench(), "d0"))
    assert rec["window_s"] == pytest.approx(0.016)
    assert rec["busy_s"] == pytest.approx(4 * 0.003)
    assert rec["device_ops_top"][0][0] == "cudnn_conv"
    names = dict(rec["idle_gaps"])
    # Each gap is named by the host event at its middle.
    assert names == {"aten::copy_": pytest.approx(4 * 0.001)}
    assert len(rec["device_ops_top"]) <= 10 and len(rec["idle_gaps"]) <= 10


def test_readers_arithmetic():
    cfg = spec.config(bench(), "d0")
    rec = synthetic_record(cfg)
    read = {n: spec.reader(n) for n in (
        "idle_share.serve", "host_ms.latency", "device_ms.latency",
        "mfu.serve", "mbconv_roofline")}
    assert read["idle_share.serve"](rec) == pytest.approx(25.0)
    assert rec["requests"] == 3
    assert read["host_ms.latency"](rec) == pytest.approx(0.3)
    assert read["device_ms.latency"](rec) == pytest.approx(3.0)
    rate = 4 * 32 / 0.016
    assert read["mfu.serve"](rec) == pytest.approx(
        100 * flops.forward_flops(cfg) * rate / 989e12)
    least = sum(bounds.mbconv_bound(s, 32)[0]
                for s in geometry.mbconv_shapes(cfg))
    assert read["mbconv_roofline"](rec) == pytest.approx(100 * least / 0.5)
    # Nothing to read: no kernel E, no traced step.
    rec["device_ops"] = {"cudnn_conv": 1.0}
    assert read["mbconv_roofline"](rec) is None
    rec["steps"] = rec["requests"] = 0
    assert read["device_ms.latency"](rec) is None
    assert read["host_ms.latency"](rec) is None


def test_kernel_names():
    assert readers.MBCONV_KERNELS.search("void mbconv_tc_kernel<3, 1>(...)")
    assert not readers.MBCONV_KERNELS.search("nms_kernel")


def test_traffic_is_deterministic():
    """Every mix's images and arrivals follow from the seed alone."""
    cfg = spec.config(bench(), "d0")
    cfg["input_size"] = 64
    seed = 2 ** 31 + 12345
    for w in bench()["workloads"]:
        mix = spec.traffic(w["traffic"])
        mix.update(batch=3, pool=2)

        def run(s):
            return types.SimpleNamespace(mix=mix, cfg=cfg, seed=s,
                                         seconds=2.0, bench_dir=BENCH,
                                         device=torch.device("cpu"))
        a, b = traffic.image_pool(run(seed)), traffic.image_pool(run(seed))
        c = traffic.image_pool(run(seed + 1))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert not np.array_equal(a[0], c[0])
        assert a[0].shape == (3, 64, 64, 3) and a[0].dtype == np.uint8
        due = traffic.arrival_times(run(seed))
        if due is not None:
            assert np.array_equal(due, traffic.arrival_times(run(seed + 1)))
            assert len(due) == int(2.0 * mix["rate_per_s"])


def test_no_jax_after_the_harness_imports():
    """The harness and everything it imports, the program included, load
    no module whose top-level name is jax, jaxlib, flax, optax, orbax or
    efficientdet_tpu (compared whole: efficientdet_tpu_torch is not)."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(1, %r)\n"
        "import run\n"
        "from harness import cell, serve, reference, check, spec\n"
        "import efficientdet_tpu_torch.eval.driver\n"
        "for m in spec.benchmark()['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "for w in spec.benchmark()['workloads']:\n"
        "    mix = spec.traffic(w['traffic'])\n"
        "    spec.module('loops', mix['loop'])\n"
        "    spec.module('images', mix['images'])\n"
        "print(','.join(cell.forbidden_modules()))\n"
        "print('efficientdet_tpu_torch' in {m.split('.')[0] for m in "
        "sys.modules})\n") % (BENCH, os.path.dirname(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout.split()
    assert out == ["True"] or out == ["", "True"]


def test_forbidden_names_compare_whole(monkeypatch):
    from harness import cell
    monkeypatch.setitem(sys.modules, "efficientdet_tpu_torch_x", sys)
    assert "efficientdet_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "efficientdet_tpu.ops", sys)
    assert cell.forbidden_modules() == ["efficientdet_tpu"]


def test_reference_imports_nothing_of_the_program():
    src = open(os.path.join(BENCH, "harness", "reference.py")).read()
    assert "efficientdet_tpu" not in src and "jax" not in src
