"""``correct`` comes out false when the timed path is broken underneath.

Each test skips the look for a card and drives the rest of a run at a
small size on the CPU, with one fault planted in the program, and holds
the run to the cell's own limits (``limits/<cell>.json``). The faults a
serving cell can have: half of each batch's answers left out, and an
answer altered where it is produced. The control, the reference with
float8 products in the program's place, fails the limits too, as on the
card at full size."""

import time

import pytest
import torch

from conftest import small_cfg, small_mix
from harness import cell, spec

SEED = 2 ** 31 + 4242


def run(workload, traffic, batch, pool, cfg=None, controls=()):
    r = cell.execute(workload, SEED, 0.3, False, torch.device("cpu"),
                     time.perf_counter(), cfg=cfg or small_cfg(),
                     mix=small_mix(traffic, batch, pool), controls=controls)
    return r, cell.result(r)


def exceeds(readings, limits):
    return any(limits[k] is None or v > limits[k] for k, v in readings.items())


def patch_detections(monkeypatch, alter):
    from efficientdet_tpu_torch.eval import driver
    from efficientdet_tpu_torch.ops.nms import Detections
    eval_fn = driver.Evaluator.eval_fn

    def broken(self, images):
        return Detections(*alter(eval_fn(self, images)))

    monkeypatch.setattr(driver.Evaluator, "eval_fn", broken)


@pytest.mark.parametrize("workload,traffic,batch", [
    ("d0_serve_b32", "serve_closed_b32", 2), ("d0_serve_b1", "serve_open_b1", 1)])
def test_the_sound_program_is_correct(workload, traffic, batch):
    """Without a fault the same runs come out correct, so the faults below
    are what turns them."""
    r, out = run(workload, traffic, batch, 2)
    assert r.judged and out["correct"] is True, out["checks"]


def test_serving_half_the_batch_left_out(monkeypatch):
    def alter(det):
        s, c, b, v = (t.clone() for t in det)
        half = s.shape[0] // 2
        s[half:], c[half:], b[half:], v[half:] = -1, -1, 0, False
        return s, c, b, v
    patch_detections(monkeypatch, alter)
    r, out = run("d0_serve_b32", "serve_closed_b32", 2, 2)
    assert r.judged and out["correct"] is False


def test_serving_answer_altered(monkeypatch):
    def alter(det):
        s, c, b, v = (t.clone() for t in det)
        c = torch.where(v, (c + 1) % 80, c)
        return s, c, b, v
    patch_detections(monkeypatch, alter)
    r, out = run("d0_serve_b1", "serve_open_b1", 1, 2)
    assert r.judged and out["correct"] is False


@pytest.mark.parametrize("workload,traffic,batch,pool", [
    ("d0_serve_b32", "serve_closed_b32", 2, 1),
    ("d0_serve_b1", "serve_open_b1", 1, 2)])
def test_the_control_fails_the_limits(workload, traffic, batch, pool):
    r, _ = run(workload, traffic, batch, pool, controls=("fp8",))
    assert exceeds(r.control_readings["fp8"], spec.limits(workload))
