"""The plain reference against the program's own step at a small size on
the CPU, both in float32: they agree, so on the card the gaps that the
limits hold are the program's precision and nothing else. The test imports
both; the reference imports nothing of the program."""

import os
import time

import numpy as np
import torch

from conftest import small_cfg, small_mix
from harness import cell, reference, serve, spec

SEED = 2 ** 31 + 77


def f32(cfg):
    cfg["dtype"] = "float32"
    return cfg


def test_forward_and_detections_agree():
    cfg = f32(small_cfg())
    dev = torch.device("cpu")
    state = serve.seeded_state(cfg, SEED, dev)
    path = serve.weights_file(state)
    try:
        ev = serve.evaluator(cfg, 2, path, "cpu")
    finally:
        os.remove(path)
    model = ev.model
    images = spec.module("images", "uniform_uint8").pool(
        small_mix("serve_open_b1", 2, 1), cfg, SEED, dev)[0]
    x = torch.from_numpy(images)
    from efficientdet_tpu_torch.train.train_lib import maybe_normalize_images
    with torch.no_grad():
        logits, deltas = model.train_forward(maybe_normalize_images(x))
        cls_l, reg_l = reference.Net(cfg, state)(x)
    torch.testing.assert_close(torch.cat(cls_l, 1), logits.float(),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(torch.cat(reg_l, 1), deltas.float(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(model.anchors, reference.anchors(cfg, dev))
    served = serve.request(ev.eval_fn, images)
    for lo, ref_logits, boxes, det in serve.reference_pass(cfg, state, images,
                                                           dev):
        for k in range(ref_logits.shape[0]):
            s = {f: served[f][lo + k] for f in serve.FIELDS}
            r = {f: det[f][k] for f in serve.FIELDS}
            assert s["valid"].sum() == 100
            np.testing.assert_array_equal(s["classes"], r["classes"])
            np.testing.assert_allclose(s["scores"], r["scores"], atol=1e-5)
            np.testing.assert_allclose(s["boxes"], r["boxes"], atol=1e-3)


def test_serving_cell_agrees():
    """The serving loop end to end: every output of the window, judged."""
    cfg = f32(small_cfg())
    r = cell.execute("d0_serve_b32", SEED, 0.5, False, torch.device("cpu"),
                     time.perf_counter(), cfg=cfg,
                     mix=small_mix("serve_closed_b32", 2, 2))
    assert r.failed == 0 and r.judged >= 2
    assert r.checks["det_logit_gap"] < 1e-3
    assert r.checks["det_miss_share"] == 0
    assert r.metrics["serve_img_s"] > 0 and r.metrics["setup_s"] > 0
