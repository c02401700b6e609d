"""The RetinaNet cell and the eval-files loop at a size a test run holds, on
the CPU: the shapes' arithmetic against a hand count, the new readers on
synthetic records, the new image sources, and each loop end to end (float32
program against the reference: correct; the float8 control: not).

The eval-files cell is not in ``BENCHMARK.json`` (its ``serve_img_s``
spread too widely on the card's shared host, ``PERF.md`` section 7): its
tests add the entry, as a later change would, to a copy of the file."""

import time

import numpy as np
import pytest
import torch

from conftest import small_cfg, small_mix
from harness import cell, retinanet, spec

SEED = 2 ** 31 + 1919


def r50():
    return spec.config(spec.benchmark(), "retinanet_r50")


def small_r50(hw=(64, 96)):
    cfg = r50()
    cfg["input_hw"] = list(hw)
    cfg["dtype"] = "float32"
    return cfg


def test_config_follows_its_source():
    """800 x 1344: C2 200 x 336 .. C5 25 x 42, P6 13 x 21, P7 7 x 11,
    22,400 cells, 201,600 anchors."""
    cfg = r50()
    assert [s for _, s in retinanet.stage_outputs(cfg)] == [
        (200, 336), (100, 168), (50, 84), (25, 42)]
    assert [c for c, _ in retinanet.stage_outputs(cfg)] == [256, 512, 1024,
                                                            2048]
    assert retinanet.pyramid(cfg) == [(100, 168), (50, 84), (25, 42),
                                      (13, 21), (7, 11)]
    assert retinanet.num_anchors(cfg) == 201600
    assert len(retinanet.bottlenecks(cfg)) == 16


def test_flops_by_hand():
    """One bottleneck (layer3's first: 512 -> 256 -> 1024 at stride 2, 100 x
    168 in, 50 x 84 out, with its downsample) and one FPN level (P4: the
    1024 -> 256 lateral and the 3x3 output conv over 50 x 84), by hand;
    the parts' totals: ResNet-50 ~87.6 GMAC, FPN ~18.2, head ~144.7."""
    cfg = r50()
    b = retinanet.bottlenecks(cfg)[7]
    assert (b["cin"], b["mid"], b["stride"]) == (512, 256, 2)
    assert (b["hw_in"], b["hw_out"]) == ((100, 168), (50, 84))
    hand = (100 * 168 * 512 * 256 + 50 * 84 * 256 * 256 * 9
            + 50 * 84 * 256 * 1024 + 50 * 84 * 512 * 1024)
    assert retinanet.block_macs(b) == hand
    # A second layer3 block adds 1x1, 3x3, 1x1 at 50 x 84, no downsample.
    one = dict(cfg, stage_blocks=[3, 4, 1, 3])
    two = dict(cfg, stage_blocks=[3, 4, 2, 3])
    assert (retinanet.conv_macs(two)["backbone"]
            - retinanet.conv_macs(one)["backbone"]) == (
        50 * 84 * (1024 * 256 + 256 * 256 * 9 + 256 * 1024))
    p4 = 50 * 84 * (1024 * 256 + 256 * 256 * 9)
    macs = retinanet.conv_macs(cfg)
    rest = (100 * 168 * (512 * 256 + 256 * 256 * 9)
            + 25 * 42 * (2048 * 256 + 256 * 256 * 9)
            + 13 * 21 * 2048 * 256 * 9 + 7 * 11 * 256 * 256 * 9)
    assert macs["fpn"] == p4 + rest
    assert 87.0e9 < macs["backbone"] < 88.2e9
    assert 18.0e9 < macs["fpn"] < 18.4e9
    assert 144.4e9 < macs["head"] < 145.0e9
    assert retinanet.forward_flops(cfg) == 2 * sum(macs.values())


FILES = {"name": "d0_eval_files_b32", "config": "d0",
         "traffic": "eval_files_b32", "chips": 1, "why": "x"}
WAIT = {"name": "data_wait_ms.files", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "host data path",
        "moves": "serve_img_s", "workloads": ["d0_eval_files_b32"]}


def files_bench():
    """``BENCHMARK.json`` with the eval-files cell and its metric added."""
    b = spec.benchmark()
    b["workloads"].append(FILES)
    b["per_layer"].append(WAIT)
    for m in b["end_to_end"]:
        if m["name"] == "serve_img_s":
            m["workloads"].append(FILES["name"])
    return b


def files_run(trace, mix_extra=()):
    from efficientdet_tpu_torch import native
    if not native.available():
        pytest.skip("the C++ JPEG pipeline does not build here")
    cfg = small_cfg()
    cfg["dtype"] = "float32"
    cfg["fused_backbone"] = False
    mix = small_mix("eval_files_b32", 4, 2)
    mix.update(file_hw=[96, 128], **dict(mix_extra))
    b = files_bench()
    r = cell.execute("d0_eval_files_b32", SEED, 0.5, trace,
                     torch.device("cpu"), time.perf_counter(), bench=b,
                     cfg=cfg, mix=mix)
    return r, cell.result(r, b)


def _record(cfg, program=None):
    rec = {"steps": 4, "images": 32, "window_s": 0.2, "busy_s": 0.19,
           "device_ops": {}, "requests": 4, "request_idle_s": 0.0,
           "cfg": cfg, "mix": {}}
    if program is not None:
        rec["program"] = program
    return rec


def test_readers_arithmetic():
    cfg = r50()
    mfu = spec.reader("mfu.retinanet")
    assert mfu(_record(cfg)) == pytest.approx(
        100 * retinanet.forward_flops(cfg) * 160 / 989e12)
    assert mfu(dict(_record(cfg), images=0)) is None
    wait = spec.reader("data_wait_ms.files")
    summary = {"eval.data_wait": {"count": 9, "wall_s": 0.45,
                                  "self_s": 0.45},
               "serve.eval_fn": {"count": 8, "wall_s": 0.1, "self_s": 0.1}}
    assert wait(_record(cfg, {"summary": summary})) == pytest.approx(50.0)
    # Nothing to read: no program spans (the parent's record), or no wait.
    assert wait(_record(cfg)) is None
    assert wait(_record(cfg, {"summary": {"serve.eval_fn": {
        "count": 1, "wall_s": 0.1, "self_s": 0.1}}})) is None


@pytest.mark.parametrize("images,cfg,shape", [
    ("uniform_uint8_hw", small_r50((40, 72)), (3, 40, 72, 3)),
    ("uniform_uint8_hw", {"input_size": 48}, (3, 48, 48, 3)),
    ("smooth_uint8", {"input_size": 48}, (3, 48, 48, 3))])
def test_image_sources(images, cfg, shape):
    mix = {"batch": 3, "pool": 2}
    source = spec.module("images", images)
    a = source.pool(mix, cfg, SEED, torch.device("cpu"))
    b = source.pool(mix, cfg, SEED + 1, torch.device("cpu"))
    assert len(a) == 2 and a[0].shape == shape and a[0].dtype == np.uint8
    assert not np.array_equal(a[0], b[0])


def test_retinanet_cell_end_to_end():
    """The RetinaNet loop at 64 x 96, float32: every output of the window
    judged correct; the float8 control fails the cell's limits."""
    r = cell.execute("retinanet_r50_serve_b8", SEED, 0.3, False,
                     torch.device("cpu"), time.perf_counter(),
                     cfg=small_r50(), controls=("fp8",),
                     mix=small_mix("serve_closed_b8_hw", 2, 2))
    out = cell.result(r)
    assert r.failed == 0 and r.judged >= 2 and out["correct"] is True, \
        out["checks"]
    assert r.checks["det_logit_gap"] < 1e-3
    assert r.metrics["serve_img_s"] > 0
    limits = spec.limits("retinanet_r50_serve_b8")
    assert any(r.control_readings["fp8"][k] > v for k, v in limits.items())


def test_eval_files_cell_end_to_end():
    """D0 at 128 px over 8 JPEGs written in set-up, batches of 4: the
    entry point's loop pass after pass, every output judged correct against
    the reference on the very batch the loader made."""
    r, out = files_run(False)
    assert r.notes["native_active"] is True
    assert r.failed == 0 and r.judged == 8 and out["correct"] is True, \
        out["checks"]
    assert r.attempted >= 2 and r.metrics["serve_img_s"] > 0


def test_traced_eval_files_records_the_program_wait(monkeypatch):
    """With ``--trace 1`` the loop turns the program's spans on for the
    traced requests and the record carries ``eval.data_wait``."""
    from harness import run_state
    monkeypatch.setattr(run_state, "TRACE_LEAD_S", 0.0)
    r, out = files_run(True, {"trace_requests": 2})
    assert r.record is not None
    assert spec.reader("data_wait_ms.files")(r.record) > 0
    assert "data_wait_ms.files" in out["metrics"]
