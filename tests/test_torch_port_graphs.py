"""``graphed_eval_step``, the port's ``jax.jit`` of the serving step, on
the CPU.

- CPU images go through the eager step: the graphed step of the serving
  slice's small detector (``tests/test_torch_port_slice.py``, 128 px)
  equals JAX's jitted ``make_eval_step`` on JAX's own variables (scores
  within 1e-5, boxes within 1e-3 px, the slice test's tolerances) and the
  eager step bit for bit, and captures nothing.
- The wrapper's bookkeeping, with ``torch.cuda.CUDAGraph`` and the capture
  context (``graphed._capture``) replaced by stand-ins that record the
  captured callable and rerun it on replay, the other CUDA calls by no-ops,
  and ``graphed._on_card`` saying yes: one capture per (shape, dtype),
  replays without a new capture, results that alias neither the graph's
  outputs nor each other, launch counters credited per replay by what the
  capture added, a first replay that differs from the eager step raising,
  and the refusals (a model bound to the spatial axis, images that require
  a gradient, parameters replaced since the capture).
- The entry points serve through it: the eval driver (one graph for a
  whole pass, the last batch padded), the demo, and ``shard_eval_step``
  on the data axis of a gloo group of one (the all-gather after the
  replay).

The graph itself, on the card, is ``tests/test_torch_port_cuda.py``'s and
``chip_smoke.py::phase_graphs``' to check.
"""

import contextlib
import socket
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientdet_tpu.train import make_eval_step as jax_make_eval_step
from efficientdet_tpu_torch import (DetectorConfig, EfficientDet,
                                    create_train_state, make_eval_step)
from efficientdet_tpu_torch import kernels
from efficientdet_tpu_torch.kernels import fusion
from efficientdet_tpu_torch.kernels.nms_kernel import nms_select
from efficientdet_tpu_torch.train import graphed, graphed_eval_step
from efficientdet_tpu_torch.utils import checkpoint as ckpt
from test_torch_port_slice import (CFG, SIZE, _port,  # noqa: F401
                                   _precision, jax_model, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")

SMALL = dict(num_classes=4, network="efficientdet-d0", input_size=SIZE,
             W_bifpn=16, D_bifpn=1, D_class=1, head_stacked_convs=1,
             head_feat_channels=16)
# What the small detector's fusion path launches per step on the card: one
# NMS, 4 top-down and 3 bottom-up nodes in its one BiFPN module.
STEP_LAUNCHES = {nms_select: 1, fusion.fuse_topdown: 4,
                 fusion.fuse_bottomup: 3}


def _uint8(seed, b=2):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, size=(b, SIZE, SIZE, 3)).astype(np.uint8))


@pytest.fixture(scope="module")
def port(jax_model):
    return _port(jax_model[1])


def test_graphed_step_on_cpu_matches_jax_jit(port, jax_model):
    """CPU images: JAX's jitted eval step on its own variables, within the
    slice test's tolerances; the eager step exactly; no graph."""
    model, variables = jax_model
    images = _uint8(5)
    want = jax.jit(jax_make_eval_step(model, CFG))(variables,
                                                   jnp.asarray(images.numpy()))
    step = graphed_eval_step(make_eval_step(port, CFG))
    got = step(images)
    assert int(got.valid.sum()) > 20 and not step.graphs
    for name in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)
    eager = make_eval_step(port, CFG)(images)
    assert all(torch.equal(a, b) for a, b in zip(got, eager))


# ------------------------------------------------- the wrapper's bookkeeping
class FakeGraph:
    """``torch.cuda.CUDAGraph``'s stand-in: ``replay`` reruns the captured
    callable into the captured outputs, leaving the launch counters as a
    replay on the card does (the wrapper credits them)."""

    made = []

    def __init__(self):
        self.fn = self.out = None
        self.replays = 0
        FakeGraph.made.append(self)

    def replay(self):
        counts = [fn.launches for fn in kernels.KERNELS]
        for static, new in zip(self.out, self.fn()):
            static.copy_(new)
        for fn, n in zip(kernels.KERNELS, counts):
            fn.launches = n
        self.replays += 1


def fake_capture(graph, fn, pool, stream):
    graph.fn, graph.out = fn, fn()
    return graph.out


class FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeGraph.made = []
    # One warm-up step instead of three: on the CPU each is a whole eager
    # step, and the bookkeeping does not depend on the count.
    monkeypatch.setattr(graphed, "WARMUP", 1)
    monkeypatch.setattr(graphed, "_on_card", lambda images: True)
    monkeypatch.setattr(graphed, "_capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return FakeGraph


def _small_model(seed=0):
    model = EfficientDet(DetectorConfig(**SMALL), use_fusion_kernels=True,
                         device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    return model.eval().to(memory_format=torch.channels_last)


def _counting_step(model):
    """The small detector's eager step, adding to the counters what its
    kernels' wrappers add on the card (the plain versions add nothing)."""
    step = make_eval_step(model, model.config)

    def counting(images):
        for fn, n in STEP_LAUNCHES.items():
            fn.launches += n
        return step(images)

    counting.model = model
    return counting


def _counts():
    return {fn: fn.launches for fn in STEP_LAUNCHES}


def test_one_capture_per_shape_and_dtype(fake_cuda):
    model = _small_model()
    step = graphed_eval_step(make_eval_step(model, model.config))
    x2, x1 = _uint8(1), _uint8(2, b=1)
    for images in (x2, x2, x1, x2, x2.float(), x1):
        step(images)
    assert [(k[0][0], k[1]) for k in step.graphs] == [
        (2, torch.uint8), (1, torch.uint8), (2, torch.float32)]
    assert len(fake_cuda.made) == 3
    # Each capture replays once to check itself; the rest are plain replays.
    assert [g.replays for g in fake_cuda.made] == [3, 2, 1]
    assert graphed_eval_step(step) is step


def test_replays_equal_eager_and_do_not_alias(fake_cuda):
    model = _small_model()
    eager = make_eval_step(model, model.config)
    step = graphed_eval_step(eager)
    a, b = _uint8(3), _uint8(4)
    det_a = step(a)
    kept_a = [t.clone() for t in det_a]
    det_b = step(b)
    static = step.graphs[next(iter(step.graphs))].detections
    for got, want in ((det_a, eager(a)), (det_b, eager(b))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(t, k) for t, k in zip(det_a, kept_a))
    assert not torch.equal(det_a.scores, det_b.scores)
    ptrs = {t.data_ptr() for t in static}
    assert not ptrs & {t.data_ptr() for t in (*det_a, *det_b)}


def test_launches_credited_per_replay(fake_cuda):
    model = _small_model()
    step = graphed_eval_step(_counting_step(model))
    before = _counts()
    step(_uint8(1))   # WARMUP eager steps, a capture, the first replay
    first = {fn: n - before[fn] for fn, n in _counts().items()}
    assert first == {fn: (graphed.WARMUP + 1) * n
                     for fn, n in STEP_LAUNCHES.items()}
    entry = next(iter(step.graphs.values()))
    assert dict(entry.launches) == STEP_LAUNCHES
    for _ in range(4):
        step(_uint8(1))
    assert {fn: n - before[fn] for fn, n in _counts().items()} == {
        fn: (graphed.WARMUP + 5) * n for fn, n in STEP_LAUNCHES.items()}


def test_first_replay_that_differs_raises(fake_cuda, monkeypatch):
    def bad_capture(graph, fn, pool, stream):
        def shifted():
            det = fn()
            return det._replace(scores=det.scores + 1.0)
        return fake_capture(graph, shifted, pool, stream)

    monkeypatch.setattr(graphed, "_capture", bad_capture)
    model = _small_model()
    step = graphed_eval_step(make_eval_step(model, model.config))
    with pytest.raises(RuntimeError, match="differs from the eager step in "
                                           "scores"):
        step(_uint8(1))
    assert not step.graphs


def test_refusals(fake_cuda):
    model = _small_model()
    step = graphed_eval_step(make_eval_step(model, model.config))
    with pytest.raises(ValueError, match="make_eval_step's step"):
        graphed_eval_step(lambda images: None)
    images = _uint8(1)
    step(images)
    with pytest.raises(ValueError, match="require a gradient"):
        step(images.float().requires_grad_())
    model.spatial = object()
    try:
        with pytest.raises(ValueError, match="spatial axis"):
            step(images)
    finally:
        model.spatial = None
    # In place, new weights are served: no refusal.
    model.load_state_dict(_small_model(seed=1).state_dict())
    assert torch.equal(step(images).scores,
                       make_eval_step(model, model.config)(images).scores)
    conv = model.bbox_head.retina_cls
    conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
    with pytest.raises(ValueError, match="were replaced"):
        step(images)


def test_moved_tensors_refused(fake_cuda):
    model = _small_model()
    step = graphed_eval_step(make_eval_step(model, model.config))
    step(_uint8(1))
    model.to(torch.float64)
    with pytest.raises(ValueError, match="were replaced"):
        step(_uint8(1))


# ------------------------------------------------------ the entry points
@pytest.fixture(scope="module")
def small_blob(tmp_path_factory):
    model = EfficientDet(DetectorConfig(**SMALL), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return ckpt.save_checkpoint(str(tmp_path_factory.mktemp("graphs")),
                                create_train_state(model),
                                DetectorConfig(**SMALL).resolve(), epoch=0)


def test_eval_driver_serves_one_graph_per_pass(fake_cuda, small_blob,
                                               monkeypatch):
    """Five images at B = 2: three batches, the last padded, one graph;
    the pass's mAP and detections equal the eager pass's."""
    from efficientdet_tpu_torch.eval import driver
    argv = ["--dataset", "synthetic", "--weight", small_blob, "--device",
            "cpu", "--synthetic_length", "5", "--batch_size", "2",
            "--threshold", "0.0"]
    evaluator = driver.Evaluator(driver.parse_args(argv))
    assert isinstance(evaluator.eval_step, graphed.GraphedEvalStep)
    summary = evaluator.run()
    assert len(evaluator.eval_step.graphs) == 1
    assert [g.replays for g in fake_cuda.made] == [3]
    monkeypatch.setattr(graphed, "_on_card", lambda images: False)
    eager = driver.Evaluator(driver.parse_args(argv)).run()
    assert (summary["mAP"], summary["detections"]) == (eager["mAP"],
                                                       eager["detections"])


def test_graph_spans(fake_cuda, small_blob):
    """The eval entry point's request over the graph's spans
    (``utils/tracing.py``): a capture at the first call, then a check, the
    static copy, a replay and the clones."""
    from efficientdet_tpu_torch.eval import driver
    from efficientdet_tpu_torch.utils import tracing
    evaluator = driver.Evaluator(driver.parse_args(
        ["--dataset", "synthetic", "--weight", small_blob, "--device", "cpu",
         "--synthetic_length", "2", "--batch_size", "2"]))
    tracing.enable()
    try:
        calls = []
        for seed in (1, 2):
            evaluator.eval_fn(_uint8(seed).numpy())
            calls.append(tracing.drain()["spans"])
    finally:
        tracing.disable()
        tracing.drain()

    def under(spans, parent):
        return [s.name for s in spans if s.parent == parent.id]

    for spans in calls:
        assert [s.name for s in spans if s.parent is None] == [
            "serve.eval_fn"]
    first, second = calls
    assert under(first, first[0]) == ["serve.stage", "graph.record",
                                      "graph.clone"]
    record = next(s for s in first if s.name == "graph.record")
    assert under(first, record) == ["graph.warmup", "graph.capture",
                                    "graph.verify"]
    assert under(second, second[0]) == ["serve.stage", "graph.check",
                                        "serve.stage", "graph.replay",
                                        "graph.clone"]
    assert "graph.record" not in {s.name for s in second}


def test_demo_serves_through_a_graph(fake_cuda, small_blob):
    from efficientdet_tpu_torch import demo
    detect = demo.Detect(demo.parse_args(
        ["--weight", small_blob, "--device", "cpu", "--score_threshold",
         "0.0"]))
    img = np.random.RandomState(0).rand(SIZE, SIZE, 3).astype(np.float32)
    boxes, _, scores = detect.process(img)
    assert len(detect.eval_step.graphs) == 1 and len(boxes) == 100
    boxes2, _, scores2 = detect.process(img)
    assert np.array_equal(boxes, boxes2) and np.array_equal(scores, scores2)
    assert fake_cuda.made[0].replays == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_shard_eval_step_graphs_the_ranks_step(fake_cuda, monkeypatch):
    """A gloo group of one: the data axis serves the rank's step from a
    graph and gathers after the replay, equal to the eager step; a
    callable that is not ``make_eval_step``'s runs as it is."""
    from efficientdet_tpu_torch.parallel import create_mesh, shard_eval_step
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    mesh = create_mesh(1, 1, backend="gloo", device="cpu",
                       init_method=f"tcp://localhost:{_free_port()}")
    try:
        model = _small_model()
        eager = make_eval_step(model, model.config)
        sharded = shard_eval_step(eager, mesh)
        images = _uint8(6)
        for _ in range(2):
            got = sharded(images)
        assert [g.replays for g in fake_cuda.made] == [2]
        assert all(torch.equal(a, b) for a, b in zip(got, eager(images)))
        other = shard_eval_step(lambda x: eager(x), mesh)(images)
        assert len(fake_cuda.made) == 1
        assert all(torch.equal(a, b) for a, b in zip(other, got))
    finally:
        mesh.close()


def test_spatial_axis_runs_a_graphed_step_eagerly(fake_cuda, monkeypatch):
    """Under the spatial axis ``shard_eval_step`` runs the eager step that
    a graphed step holds, with the model bound to its plan, and captures
    nothing (a stand-in two-rank spatial group whose gather hands back the
    rank's own detections)."""
    from efficientdet_tpu_torch.parallel import mesh as mesh_mod
    model = _small_model()
    images = _uint8(7)
    det = make_eval_step(model, model.config)(images)
    plan, seen = object(), []

    def step(x):
        seen.append(model.spatial)
        return det

    step.model = model
    group = types.SimpleNamespace(group=object(), num_spatial=2, num_data=1,
                                  data_rank=0)
    monkeypatch.setattr(mesh_mod, "_plan", lambda *args: plan)
    monkeypatch.setattr(mesh_mod, "all_gather", lambda t, group: [t, t])
    got = mesh_mod.shard_eval_step(graphed_eval_step(step), group)(images)
    assert seen == [plan] and model.spatial is None and not fake_cuda.made
    assert all(torch.equal(a, b) for a, b in zip(got, det))
