"""The port's spans (``efficientdet_tpu_torch/utils/tracing.py``) on the CPU.

- Off: a span is one shared no-op; nothing is recorded and no profiler
  range is entered, not even while a profiler records.
- On: nesting gives each span its parent and its request, and the summary
  each name's self time; an unknown name raises; the kernel wrappers'
  ``.launches`` are read, not counted again.
- Under a CPU ``torch.profiler`` every span is a profiler range of its own
  name, on the profiler's clock: the in-memory starts and ends differ from
  the profiler's by one offset, within 50 us.
- The layers: the eval entry point's set-up and ``eval_fn``, the train
  step's parts with and without a gradient reduction, and the training
  driver's ``--profile_dir`` trace.
- ``PERF.md`` names every span of ``SPANS``.

The CUDA graph's spans are ``tests/test_torch_port_graphs.py``'s.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from efficientdet_tpu_torch import (DetectorConfig, EfficientDet,
                                    create_train_state, make_train_step)
from efficientdet_tpu_torch.kernels import fusion
from efficientdet_tpu_torch.kernels.nms_kernel import nms_select
from efficientdet_tpu_torch.train import graphed
from efficientdet_tpu_torch.utils import checkpoint as ckpt
from efficientdet_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128
SMALL = dict(num_classes=4, network="efficientdet-d0", input_size=SIZE,
             W_bifpn=16, D_bifpn=1, D_class=1, head_stacked_convs=1,
             head_feat_channels=16)


@pytest.fixture(autouse=True)
def clean():
    """Every test starts and ends with tracing off and nothing recorded."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_ranges(monkeypatch):
    """Profiler ranges, both forms, raise if entered."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)


def _names(spans):
    return [s.name for s in spans]


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.fixture(scope="module")
def small_blob(tmp_path_factory):
    model = EfficientDet(DetectorConfig(**SMALL), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return ckpt.save_checkpoint(str(tmp_path_factory.mktemp("tracing")),
                                create_train_state(model),
                                DetectorConfig(**SMALL).resolve(), epoch=0)


def _images(seed, b=2):
    return np.random.RandomState(seed).randint(
        0, 256, size=(b, SIZE, SIZE, 3)).astype(np.uint8)


# ------------------------------------------------------------- the module
def test_off_records_nothing_and_enters_no_range(monkeypatch, small_blob):
    """Off, under a running profiler too: the shared no-op, nothing
    recorded, no range entered, whatever the name."""
    from efficientdet_tpu_torch.eval import driver
    _no_ranges(monkeypatch)
    assert tracing.span("serve.eval_fn") is tracing.span("no.such.span")
    evaluator = driver.Evaluator(driver.parse_args(
        ["--dataset", "synthetic", "--weight", small_blob, "--device", "cpu",
         "--synthetic_length", "2", "--batch_size", "2"]))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        evaluator.eval_fn(_images(0))
        with tracing.span("serve.stage"):
            pass
    assert tracing.drain()["spans"] == []


def test_nesting_parent_request_and_self_time():
    tracing.enable()
    with tracing.span("train.step"):
        time.sleep(0.01)
        with tracing.span("train.forward_loss"):
            with tracing.span("model.backbone"):
                time.sleep(0.02)
        with tracing.span("train.backward"):
            time.sleep(0.01)
    with tracing.span("train.step"):
        pass
    out = tracing.drain()
    spans = out["spans"]
    assert _names(spans) == ["train.step", "train.forward_loss",
                             "model.backbone", "train.backward",
                             "train.step"]
    step, fwd, bb, bwd, step2 = spans
    assert step.parent is None and step2.parent is None
    assert (fwd.parent, bwd.parent, bb.parent) == (step.id, step.id, fwd.id)
    assert fwd.request == bb.request == bwd.request == step.request
    assert step2.request != step.request
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert step.start_ns <= fwd.start_ns <= bb.start_ns
    assert bb.end_ns <= fwd.end_ns <= bwd.start_ns <= step.end_ns
    summary = out["summary"]
    assert summary["train.step"]["count"] == 2
    wall = (step.end_ns - step.start_ns) / 1e9
    inner = (fwd.end_ns - fwd.start_ns + bwd.end_ns - bwd.start_ns) / 1e9
    assert summary["train.forward_loss"]["self_s"] == pytest.approx(
        (fwd.end_ns - fwd.start_ns - bb.end_ns + bb.start_ns) / 1e9)
    first = summary["train.step"]["self_s"] - (step2.end_ns
                                               - step2.start_ns) / 1e9
    assert first == pytest.approx(wall - inner)
    assert 0.009 < first < wall


def test_summarize_arithmetic():
    S = tracing.Span
    spans = [S("serve.eval_fn", 0, 10_000, None, 0, 1),
             S("serve.stage", 1_000, 4_000, 1, 0, 2),
             S("graph.replay", 5_000, 6_000, 1, 0, 3),
             S("serve.eval_fn", 20_000, 25_000, None, 1, 4),
             S("serve.stage", 21_000, 22_000, 4, 1, 5)]
    got = tracing.summarize(spans)
    assert got["serve.eval_fn"] == pytest.approx(
        {"count": 2, "wall_s": 15e-6, "self_s": 10e-6})
    assert got["serve.stage"] == pytest.approx(
        {"count": 2, "wall_s": 4e-6, "self_s": 4e-6})
    assert got["graph.replay"]["self_s"] == pytest.approx(1e-6)


def test_unknown_name_raises_when_on():
    tracing.enable()
    with pytest.raises(ValueError, match="no span 'serve.typo'"):
        tracing.span("serve.typo")
    assert all(isinstance(n, str) and n.count(".") == 1
               for n in tracing.SPANS)
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)


def test_threads_keep_their_own_stacks():
    """Eight threads open nested spans at once, with a short switch
    interval: every span is kept once, under its own thread's parent."""
    tracing.enable()
    per_thread = 300

    def work():
        for _ in range(per_thread):
            with tracing.span("train.step"):
                with tracing.span("train.data_wait"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.span("serve.eval_fn"):
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    spans = tracing.drain()["spans"]
    by = _by_name(spans)
    assert len(by["train.step"]) == len(by["train.data_wait"]) == 8 * 300
    assert len({s.id for s in spans}) == len(spans)
    steps = {s.id: s for s in by["train.step"]}
    assert all(s.parent is None for s in steps.values())
    assert len({s.request for s in steps.values()}) == len(steps)
    for w in by["train.data_wait"]:
        assert w.request == steps[w.parent].request


def test_counters_are_the_wrappers_own(monkeypatch):
    """``drain`` reads every ``.launches`` of ``graphed.COUNTED`` as it
    stands; a span adds no launch."""
    for fn in graphed.COUNTED:
        monkeypatch.setattr(fn, "launches", 0)
    nms_select.launches += 2
    fusion.fuse_topdown.launches += 5
    tracing.enable()
    with tracing.span("graph.replay"):
        pass
    counters = tracing.drain()["counters"]
    assert counters == {f"kernel.{fn.__name__}": fn.launches
                        for fn in graphed.COUNTED}
    assert counters["kernel.nms_select"] == 2
    assert counters["kernel.fuse_topdown"] == 5
    assert sum(counters.values()) == 7
    assert tracing.drain()["spans"] == []


def test_on_without_a_profiler_enters_no_range(monkeypatch):
    _no_ranges(monkeypatch)
    tracing.enable()
    with tracing.span("serve.eval_fn"), tracing.span("serve.stage"):
        pass
    assert _names(tracing.drain()["spans"]) == ["serve.eval_fn",
                                                "serve.stage"]


def test_spans_are_profiler_ranges_on_one_clock():
    """Each span is a range of the same name in a CPU profile, and its
    in-memory start and end sit one offset from the profiler's."""
    tracing.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("train.step"):   # the first range pays its setup
            pass
        for k in range(20):
            with tracing.span("serve.eval_fn"):
                with tracing.span("serve.stage"):
                    torch.ones(256).sum()
                time.sleep(0.0005 * (k % 3))
    spans = [s for s in tracing.drain()["spans"] if s.name != "train.step"]
    ranges = sorted((ev for ev in prof.events()
                     if ev.name in ("serve.eval_fn", "serve.stage")),
                    key=lambda ev: ev.time_range.start)
    assert _names(spans) == [ev.name for ev in ranges]
    offsets = [s.start_ns / 1e3 - ev.time_range.start for s, ev in
               zip(spans, ranges)]
    offsets += [s.end_ns / 1e3 - ev.time_range.end for s, ev in
                zip(spans, ranges)]
    assert max(offsets) - min(offsets) < 50.0


# ------------------------------------------------------------- the layers
def test_eval_entry_point_spans(small_blob):
    """Set-up: the build (construction, then ``channels_last``) and the
    weights; a request: ``serve.eval_fn`` over ``serve.stage`` and, on
    the CPU's eager step, the model's parts and the serving tail."""
    from efficientdet_tpu_torch.eval import driver
    tracing.enable()
    evaluator = driver.Evaluator(driver.parse_args(
        ["--dataset", "synthetic", "--weight", small_blob, "--device", "cpu",
         "--synthetic_length", "2", "--batch_size", "2"]))
    setup = tracing.drain()
    assert [n for n in _names(setup["spans"]) if n.startswith("setup.")] == [
        "setup.build", "setup.load_weights", "setup.build"]
    assert setup["summary"]["setup.build"]["count"] == 2
    for k in range(2):
        evaluator.eval_fn(_images(k))
    spans = tracing.drain()["spans"]
    top = [s for s in spans if s.parent is None]
    assert _names(top) == ["serve.eval_fn"] * 2
    by = _by_name(spans)
    for name in ("serve.stage", "model.backbone", "model.bifpn",
                 "model.head", "serve.postprocess"):
        assert len(by[name]) == 2, name
    for call in top:
        inside = [s for s in spans if s.request == call.request]
        assert {s.name for s in inside if s.parent == call.id} == {
            "serve.stage", "model.backbone", "model.bifpn", "model.head",
            "serve.postprocess"}
        assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
                   for s in inside)


@pytest.mark.parametrize("reduce", [False, True])
def test_train_step_spans(reduce):
    model = EfficientDet(DetectorConfig(**SMALL), device="cpu",
                         generator=torch.Generator().manual_seed(1))
    state = create_train_state(model)
    step = make_train_step(model, model.config)
    batch = {"images": torch.from_numpy(_images(3)),
             "annotations": torch.tensor(
                 [[[8.0, 8.0, 64.0, 72.0, 1.0], [-1.0] * 5]] * 2)}
    reduced = []
    tracing.enable()
    with tracing.span("train.step"):
        metrics = step(state, batch, 0,
                       reduced.append if reduce else None)
    spans = tracing.drain()["spans"]
    assert torch.isfinite(metrics["loss"]) and len(reduced) == int(reduce)
    root = spans[0]
    parts = [s.name for s in spans if s.parent == root.id]
    want = ["train.forward_loss", "train.backward"]
    want += ["train.reduce"] if reduce else []
    assert parts == want + ["train.apply"]
    fwd = _by_name(spans)["train.forward_loss"][0]
    assert {s.name for s in spans if s.parent == fwd.id} == {
        "model.backbone", "model.bifpn", "model.head"}


def test_driver_profile_trace_names_the_spans(tmp_path):
    """``--profile_dir``: the trace of steps 5-10 holds the driver's and
    the train step's spans, and tracing is off again afterwards."""
    from efficientdet_tpu_torch.train import driver
    prof = tmp_path / "prof"
    driver.main(["--dataset", "synthetic", "--network", "efficientdet-d0",
                 "--device", "cpu", "--input_size", str(SIZE),
                 "--batch_size", "2", "--synthetic_length", "22",
                 "--num_epoch", "1", "--eval_every", "0",
                 "--log_every", "100", "--save_folder", str(tmp_path / "sv"),
                 "--profile_dir", str(prof)])
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    for name, count in (("train.step", 6), ("train.forward_loss", 6),
                        ("train.backward", 6), ("train.apply", 6),
                        ("model.backbone", 6), ("train.data_wait", 5)):
        assert names.count(name) == count, name
    assert tracing.span("train.step") is tracing.span("train.apply")
    assert tracing.drain()["spans"] == []


def test_perf_md_names_every_span():
    with open(os.path.join(ROOT, "PERF.md")) as f:
        text = f.read()
    missing = [n for n in tracing.SPANS if f"`{n}`" not in text]
    missing += [f"kernel.{fn.__name__}" for fn in graphed.COUNTED
                if f"`kernel.{fn.__name__}`" not in text]
    assert not missing
