"""The port's spatial axis (``efficientdet_tpu_torch.parallel.spatial``,
``create_mesh(num_data, num_spatial)`` and the training driver's
``--spatial_shards``) against the JAX package, on the CPU.

- **The band plan alone**, without processes: S simulated ranks are S
  threads whose collectives meet at a barrier. A random tensor is cut into
  bands, every conv, resize and pool runs on each band through the real
  exchange, and the bands put together are bit-equal to the op on the whole
  tensor, at every height that D0 at 128, 164 and 408 px and D7 at 1636 px
  give the op, at S = 2, 3, 4.
- **Ranks**: processes of this file (its ``__main__`` block is the rank
  worker) in gloo groups met through ``file://`` rendezvous, importing no
  jax: S = 2 (1 data x 2 spatial) and a 2 x 2 mesh, on the small detector
  of ``test_torch_port_slice.py`` (W_bifpn 16, D_bifpn 1, 4 classes) at 128
  and 164 px (uneven bands; at 164 px the pyramid is 20/10/5/2/1, so P6
  and P7 have fewer rows than a rank's share), from JAX's variables. The
  train step in ``frozen`` and ``train`` BN with drop-connect patched to
  the same numpy masks on every side, against JAX's one-device
  ``make_train_step`` (``tests/test_train.py``'s spatial contract: loss
  rtol 2e-5, gradient norm rtol 2e-4; one BN mode per size, each JAX
  compile in a process of its own) and, in every case, the port's
  one-process step (every gradient within 3e-4 of its tensor's largest,
  the data-parallel tests' bound against JAX's mesh);
  the ranks' weights bit-equal after it; ``remat`` and the real
  drop-connect; serving against JAX's ``make_eval_step`` (classes equal,
  scores rtol 1e-5 atol 1e-6, boxes atol 1e-4); the exchange's backward;
  the refusals that need a group.
- **The driver** at ``--num_devices 1 --spatial_shards 2``: its start line,
  rank 0 alone writes, the blob against one process's, JAX's loader reads
  it, ``--resume`` continues it bit for bit.

JAX's own spatial step (1 x 4 and 2 x 4 meshes; ``tests/test_train.py``
runs 2 x 4) is held against the port's in cases marked ``slow``.
"""

import dataclasses
import hashlib
import json
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from efficientdet_tpu_torch import (DetectorConfig, EfficientDet,
                                    create_train_state, make_eval_step,
                                    make_train_step)
from efficientdet_tpu_torch.config import get_model_params
from efficientdet_tpu_torch.data import SyntheticDetection, collate
from efficientdet_tpu_torch.models import efficientnet as pt_efficientnet
from efficientdet_tpu_torch.models import layers
from efficientdet_tpu_torch.models.fused_serving import (
    SPATIAL_REFUSAL, fused_backbone_forward, stage_grids)
from efficientdet_tpu_torch.parallel import (create_mesh, put_batch,
                                             shard_eval_step,
                                             shard_train_step, spatial)
from efficientdet_tpu_torch.train import driver
from efficientdet_tpu_torch.utils.weights import load_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (128, 164)
MODES = ("frozen", "train")
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}   # (data, spatial)
SEED = 7
BATCH = 2
EVAL_BATCH = 4
TOTAL_BLOCKS = 16  # efficientnet-b0
REMAT_SIZE = 164
# JAX's one-device references, one compile each: a BN mode per size (the
# others are held to the port's one-process step, which
# test_torch_port_train.py holds to JAX's). XLA's cheaper LLVM settings
# take about a quarter off each compile's CPU time; they leave the float32
# results within 2e-6 of the default ones, far inside the tolerances.
JAX_STEPS = ((128, "frozen"), (164, "train"))
JAX_COMPILE_FLAGS = ("--xla_backend_optimization_level=0 "
                     "--xla_llvm_disable_expensive_passes=true")
# tests/test_train.py's spatial contract, and the gradient bound of
# test_torch_port_parallel.py against JAX's mesh.
LOSS_RTOL, GRAD_NORM_RTOL = 2e-5, 2e-4
ONE_PROCESS_GRAD_RTOL = 3e-4


def _cfg(size, bn_mode="frozen"):
    """test_torch_port_slice.CFG at ``size``, from the port's own
    configuration."""
    return DetectorConfig(num_classes=4, network="efficientdet-d0",
                          input_size=size, W_bifpn=16, D_bifpn=1, D_class=1,
                          head_stacked_convs=1, head_feat_channels=16,
                          bn_mode=bn_mode).resolve()


def _block(rate):
    return int(round(rate * TOTAL_BLOCKS / 0.2))


def _digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------- simulated ranks
class _Threads:
    """S threads' meeting point: every one posts its tensor, and each gets
    all of them, in index order."""

    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.box = [None] * size

    def meet(self, index, t):
        self.box[index] = t
        self.barrier.wait()
        out = list(self.box)
        self.barrier.wait()
        return out


class _ThreadPlan(spatial.SpatialPlan):
    """A ``SpatialPlan`` whose collectives are ``_Threads``'."""

    def __init__(self, threads, index):
        super().__init__(None, index, threads.size)
        self.threads = threads

    def all_gather(self, t):
        return [p.clone() for p in self.threads.meet(self.index, t)]

    def all_reduce_(self, t):
        parts = self.threads.meet(self.index, t.clone())
        t.copy_(sum(parts[1:], parts[0].clone()))


def _simulate(size, fn):
    """fn(plan, index) on ``size`` threads -> their results in order."""
    threads, out, errors = _Threads(size), [None] * size, []

    def run(i):
        try:
            out[i] = fn(_ThreadPlan(threads, i), i)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
            threads.barrier.abort()

    workers = [threading.Thread(target=run, args=(i,)) for i in range(size)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    if errors:
        raise errors[0]
    return out


def _banded(op, x, size):
    """``op(band, band_object)`` on ``size`` simulated ranks' bands of x,
    put together along H."""
    def fn(plan, i):
        lo, hi = spatial.band(x.shape[2], i, size)
        return op(x[:, :, lo:hi], spatial.Band(plan, x.shape[2]))
    return torch.cat(_simulate(size, fn), dim=2)


def _geometry(network, image_size):
    """(the backbone's nominal size, its depthwise (kernel, stride) kinds,
    the image height and every stage output height) of ``network`` at
    ``image_size``, by shape arithmetic on the meta device: the heights
    each op of the detector meets."""
    cfg = DetectorConfig(num_classes=80, network=network,
                         input_size=image_size).resolve()
    backbone = pt_efficientnet.EfficientNetFeatures(cfg.backbone_name,
                                                    device="meta")
    grids = stage_grids(backbone, image_size, image_size, fused=False)
    kinds = sorted({(b.block_args.kernel_size, b.block_args.stride)
                    for b in backbone._blocks})
    nominal = get_model_params(cfg.backbone_name)[1].image_size
    return nominal, kinds, [image_size, backbone._conv_stem.out_rows(
        image_size)] + [h for h, _ in grids]


GEOMETRIES = {"d0@128": ("efficientdet-d0", 128),
              "d0@164": ("efficientdet-d0", 164),
              "d0@408": ("efficientdet-d0", 408),
              "d7@1636": ("efficientdet-d7", 1636)}
WIDTH = 5


def _conv(cin, k, stride, **pad):
    conv = layers.ConvSame(cin, 2, k, stride=stride, device="cpu", **pad)
    gen = torch.Generator().manual_seed(k * 10 + stride)
    layers.normal_(conv.weight, 1.0, gen)
    layers.normal_(conv.bias, 1.0, gen)
    return conv


def _ops(nominal, kinds, heights):
    """(name, input rows, op(x, band=None)) for every op kind at the
    heights it meets: the stem and each depthwise kind (TF-SAME for the
    nominal size), the BiFPN's and head's 3x3 convs at stride 1 and 2
    (``torch_padding``), a 1x1; each pool and upsample; and between
    consecutive heights every branch of ``upsample_nearest_to`` (exact 2x,
    2x and a crop, beyond 2x) and of ``max_pool_2x2_to`` (VALID, ceil,
    pool then resize), and ``resize_nearest``."""
    image, rest = heights[0], sorted(set(heights[1:]), reverse=True)
    convs = [("stem", _conv(2, 3, 2, nominal_size=nominal), [image])]
    convs += [(f"dw{k}s{s}", _conv(2, k, s, nominal_size=nominal), rest)
              for k, s in kinds]
    convs += [("conv3", _conv(2, 3, 1, torch_padding=1), rest),
              ("conv3s2", _conv(2, 3, 2, torch_padding=1), rest),
              ("conv1", _conv(2, 1, 1), rest)]
    ops = [(name, h, conv) for name, conv, hs in convs for h in hs
           if conv.out_rows(h) >= 1]
    for h in rest:
        ops += [("subsample", h, layers.max_pool_1x1_stride2),
                ("up2", h, layers.upsample_nearest_2x)]
        if h >= 2:
            ops.append(("pool", h, layers.max_pool_2x2))
    w = WIDTH
    for big, small in zip(rest, rest[1:]):
        for target, tw in ((big, 2 * w), (big, 2 * w - 1),
                           (2 * small - 1, 2 * w), (2 * small + 1, 7)):
            ops.append(("up_to", small,
                        lambda x, b=None, t=target, v=tw:
                        layers.upsample_nearest_to(x, t, v, b)))
            ops.append(("resize", small,
                        lambda x, b=None, t=target, v=tw:
                        layers.resize_nearest(x, t, v, b)))
        for target, tw in ((big // 2, w // 2), ((big + 1) // 2, (w + 1) // 2),
                           (max(1, big // 3), 1)):
            ops.append(("pool_to", big,
                        lambda x, b=None, t=target, v=tw:
                        layers.max_pool_2x2_to(x, t, v, b)))
    return ops


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_band_plan_is_bit_equal_to_the_whole_op(geometry, size):
    """Every conv, resize and pool on S simulated ranks' bands, through the
    real exchange, put together bit-equal to the op on the whole tensor,
    at every height of the geometry (random float32, one or two channels);
    where a height is below S (D0 at 128 px: P7 has one row) some ranks
    hold no rows."""
    ops = _ops(*_geometry(*GEOMETRIES[geometry]))
    gen = torch.Generator().manual_seed(3)
    empty_bands = 0
    for name, rows, op in ops:
        channels = 2 if isinstance(op, layers.ConvSame) else 1
        x = torch.randn(2, channels, rows, WIDTH, generator=gen)
        want = op(x)
        got = _banded(op, x, size)
        assert got.shape == want.shape and torch.equal(got, want), (
            name, rows, tuple(got.shape), tuple(want.shape))
        empty_bands += min(rows, want.shape[2]) < size
    assert len(ops) > 100
    if geometry == "d0@128":  # P7 has one row
        assert empty_bands


# ----------------------------------------------------------- rank worker
def _port_model(variables, size, bn_mode="frozen", remat=False):
    model = EfficientDet(_cfg(size, bn_mode), remat=remat, device="cpu")
    load_jax_variables(model, variables)
    return model.to(memory_format=torch.channels_last)


def _rows(batch, mesh):
    """The data rank's images of a global batch (the loader's split)."""
    return {k: v[mesh.data_rank::mesh.num_data] for k, v in batch.items()}


def _train_case(job, size, mode, mesh, remat=False, fake=True):
    """One sharded step -> (metrics, {parameter: gradient} or None off
    rank 0, digest of the state after the step)."""
    model = _port_model(job["variables"], size, mode, remat)
    cfg = _cfg(size, mode)
    state = create_train_state(model)
    names = [n for n, _ in model.named_parameters()]
    grads = {}
    apply = state.apply_gradients

    def capture(gs):
        grads.update((n, g.detach().clone()) for n, g in zip(names, gs))
        apply(gs)

    def fake_drop_connect(x, rate, generator=None, shard=(0, 1)):
        rank, world = shard
        mask = job["masks"][_block(rate)][rank::world]
        return x / (1.0 - rate) * torch.from_numpy(mask)

    state.apply_gradients = capture
    real = pt_efficientnet.drop_connect
    if fake:
        pt_efficientnet.drop_connect = fake_drop_connect
    try:
        step = shard_train_step(make_train_step(model, cfg), mesh)
        metrics = step(state, put_batch(_rows(job["batch"][size], mesh),
                                        mesh), SEED)
    finally:
        pt_efficientnet.drop_connect = real
    keep = mesh.rank == 0
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in grads.items()} if keep else None,
            _digest(model.state_dict()))


def _eval_case(job, size, mesh):
    """``shard_eval_step`` on the rank's band of its data rank's images."""
    model = _port_model(job["variables"], size).eval()
    images = job["eval_images"][size]
    b = images.shape[0] // mesh.num_data
    mine = images[mesh.data_rank * b:(mesh.data_rank + 1) * b]
    det = shard_eval_step(make_eval_step(model, _cfg(size)), mesh)(
        put_batch({"images": mine}, mesh)["images"])
    return [t.numpy() for t in det]


# The exchange's backward: ops at heights whose bands are uneven, with an
# upstream gradient; each rank returns its band's input gradient and the
# op's parameter gradients.
EXCHANGE_OPS = {
    "conv3s2_same": (41, lambda: _conv(2, 3, 2, nominal_size=224)),
    "dw5s1_same": (21, lambda: _conv(2, 5, 1, nominal_size=224)),
    "conv3_torch": (5, lambda: _conv(2, 3, 1, torch_padding=1)),
    "resize_25_from_12": (12, None),
    "pool_ceil_3_from_5": (5, None),
}


def _exchange_op(name):
    rows, make = EXCHANGE_OPS[name]
    if make is not None:
        conv = make()
        return rows, conv, lambda x, b=None: conv(x, b)
    if name.startswith("resize"):
        return rows, None, lambda x, b=None: layers.upsample_nearest_to(
            x, 25, 9, b)
    return rows, None, lambda x, b=None: layers.max_pool_2x2_to(x, 3, 3, b)


def _exchange_inputs(name, rows):
    gen = torch.Generator().manual_seed(len(name))
    return torch.randn(2, 2, rows, 5, generator=gen)


def _exchange_grad(shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(5))


def _exchange_case(mesh, name):
    rows, conv, op = _exchange_op(name)
    x = _exchange_inputs(name, rows)
    g = _exchange_grad(op(x).shape)
    plan = spatial.SpatialPlan(mesh.spatial_group, mesh.spatial_rank,
                               mesh.num_spatial)
    lo, hi = spatial.band(rows, mesh.spatial_rank, mesh.num_spatial)
    xb = x[:, :, lo:hi].clone().requires_grad_()
    y = op(xb, spatial.Band(plan, rows))
    a, b = spatial.band(g.shape[2], mesh.spatial_rank, mesh.num_spatial)
    params = [] if conv is None else [conv.weight, conv.bias]
    got = torch.autograd.grad(y, [xb] + params, g[:, :, a:b])
    return [t.numpy() for t in got]


def _refusals(job, mesh):
    """The refusals that need a group: the fused backbone under the
    spatial axis, from a sharded fused-backbone eval step and from
    ``fused_backbone_forward`` on a bound backbone; ``num_data x
    num_spatial`` other than the world size."""
    out = []
    model = _port_model(job["variables"], 128).eval()
    images = put_batch({"images": job["eval_images"][128][:1]},
                       mesh)["images"]
    try:
        shard_eval_step(make_eval_step(model, _cfg(128),
                                       fused_backbone=True), mesh)(images)
    except NotImplementedError as e:
        out.append(str(e))
    model.backbone.spatial = object()
    try:
        fused_backbone_forward(model.backbone, torch.zeros(1, 128, 128, 3))
    except NotImplementedError as e:
        out.append(str(e))
    try:
        create_mesh(mesh.world_size, 2, device="cpu")
    except ValueError as e:
        out.append(str(e))
    return out


def _worker(tmp, name):
    """One rank of mesh ``name``: every case of the job in ``tmp``, results
    to ``tmp/{name}_rank{r}.pkl``."""
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    data, spatial_ = MESHES[name]
    mesh = create_mesh(data, spatial_, device="cpu", init_method="file://"
                       + os.path.join(tmp, f"rendezvous_{name}"))
    try:
        out = {("train", size, mode): _train_case(job, size, mode, mesh)
               for size in SIZES for mode in MODES}
        out["remat"] = _train_case(job, REMAT_SIZE, "train", mesh,
                                   remat=True, fake=False)
        out["real"] = _train_case(job, REMAT_SIZE, "train", mesh,
                                  fake=False)
        for size in SIZES:
            out[("eval", size)] = _eval_case(job, size, mesh)
        if data == 1:
            out["exchange"] = {op: _exchange_case(mesh, op)
                               for op in EXCHANGE_OPS}
        out["refusals"] = _refusals(job, mesh)
    finally:
        mesh.close()
    with open(os.path.join(tmp, f"{name}_rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------- fixtures
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")


def _start(argv, log, **env):
    """A child process writing to ``log``, with the launcher variables of
    ``env`` only, and one intra-op thread."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS} | {
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH",
                                                            "")])} | env
    with open(log, "w") as out:
        return subprocess.Popen([sys.executable] + argv, cwd=ROOT, env=env,
                                stdout=out, stderr=subprocess.STDOUT)


def _wait(proc, log, timeout=600):
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, open(log).read()[-3000:]


def _batch(size):
    """Two uint8 images; image 1 has no GT."""
    ds = SyntheticDetection(length=BATCH, image_size=size, num_classes=4,
                            max_objects=4, seed=3)
    batch = collate([ds[i] for i in range(BATCH)], max_boxes=8,
                    uint8_images=True)
    batch["annotations"][1] = -1.0
    return batch


DRIVER_ARGV = ["--dataset", "synthetic", "--device", "cpu", "--input_size",
               "128", "--batch_size", "2", "--synthetic_length", "2",
               "--num_epoch", "2", "--eval_every", "1", "--log_every", "1",
               "--seed", "3"]
SPATIAL_ARGV = ["--num_devices", "1", "--spatial_shards", "2"]


@pytest.fixture(scope="module")
def job():
    """JAX's random variables of the small detector (one tree serves both
    sizes), the batches, the masks and the eval images."""
    import jax
    import jax.numpy as jnp

    from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
    from test_torch_port_slice import CFG as JAX_CFG
    from test_torch_port_slice import _random_variables

    shapes = jax.eval_shape(JaxEfficientDet(config=JAX_CFG).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 128, 128, 3)))
    rng = np.random.RandomState(11)
    return {"variables": _random_variables(shapes, np.random.RandomState(0)),
            "batch": {s: _batch(s) for s in SIZES},
            "masks": [(rng.rand(BATCH, 1, 1, 1) < 0.7).astype(np.float32)
                      for _ in range(TOTAL_BLOCKS)],
            "eval_images": {s: np.random.RandomState(12 + s).randint(
                0, 256, size=(EVAL_BATCH, s, s, 3)).astype(np.uint8)
                for s in SIZES}}


@pytest.fixture(scope="module")
def background(job, tmp_path_factory):
    """Processes of their own: the ranks of both meshes, JAX's references
    (``_jax_worker``), and the driver at --num_devices 1 --spatial_shards 2
    (run A) and in one process (run O)."""
    tmp = tmp_path_factory.mktemp("spatial")
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    procs = {}
    for name, (data, sp) in MESHES.items():
        world = data * sp
        for rank in range(world):
            procs[(name, rank)] = _start(
                [os.path.abspath(__file__), str(tmp), name],
                tmp / f"{name}_rank{rank}.log", RANK=str(rank),
                WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world))
    for size, mode in JAX_STEPS:
        procs[("jax", size, mode)] = _start(
            [os.path.abspath(__file__), str(tmp), "jax", str(size), mode],
            tmp / f"jax_{size}_{mode}.log", JAX_PLATFORMS="cpu",
            XLA_FLAGS=JAX_COMPILE_FLAGS)
    for run, extra in (("a", SPATIAL_ARGV), ("o", [])):
        procs[run] = _start(
            ["-m", "efficientdet_tpu_torch.train"] + DRIVER_ARGV + extra
            + ["--save_folder", str(tmp / run), "--log_dir",
               str(tmp / f"log_{run}")], tmp / f"driver_{run}.log")
    yield tmp, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _jax_worker(tmp, size, mode):
    """JAX's one-device train step at ``size`` in BN ``mode``
    (drop-connect patched to the job's masks) and its eval step at
    ``size``, at highest precision -> ``tmp/jax_{size}_{mode}.pkl``. One
    process per size, so that the compiles run side by side."""
    import jax

    from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
    from efficientdet_tpu.train import make_eval_step as jax_make_eval_step
    from test_torch_port_slice import CFG as JAX_CFG
    from test_torch_port_train import _jax_step

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    cfg = dataclasses.replace(JAX_CFG, input_size=size, bn_mode=mode)
    out = {("train", size, mode): _jax_step(
        job["variables"], cfg, job["batch"][size], job["masks"])[0]}
    det = jax.jit(jax_make_eval_step(JaxEfficientDet(config=cfg), cfg))(
        job["variables"], job["eval_images"][size])
    out[("eval", size)] = [np.asarray(t) for t in det]
    with open(os.path.join(tmp, f"jax_{size}_{mode}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def ranks(job, background):
    """Both meshes' ranks, JAX's references and the port's one-process
    steps (computed here while the others run)."""
    tmp, procs = background
    one = create_mesh(device="cpu")
    single = {("train", s, m): _train_case(job, s, m, one)
              for s in SIZES for m in MODES}
    single["real"] = _train_case(job, REMAT_SIZE, "train", one, fake=False)
    single.update({("eval", s): _eval_case(job, s, one) for s in SIZES})
    want = {}
    for size, mode in JAX_STEPS:
        _wait(procs[("jax", size, mode)], tmp / f"jax_{size}_{mode}.log")
        with open(tmp / f"jax_{size}_{mode}.pkl", "rb") as f:
            want.update(pickle.load(f))
    got = {}
    for name, (data, sp) in MESHES.items():
        got[name] = []
        for rank in range(data * sp):
            _wait(procs[(name, rank)], tmp / f"{name}_rank{rank}.log")
            with open(tmp / f"{name}_rank{rank}.pkl", "rb") as f:
                got[name].append(pickle.load(f))
    return {"ranks": got, "jax": want, "single": single, "job": job}


CASES = [(m, s, b) for m in MESHES for s in SIZES for b in MODES]


@pytest.mark.parametrize("mesh,size,mode", [(m, s, b) for m in MESHES
                                            for s, b in JAX_STEPS])
def test_spatial_step_matches_jax(ranks, mesh, size, mode):
    """Every rank reports the global metrics, equal on all ranks, and
    within tests/test_train.py's spatial contract of JAX's one-device step
    on the same weights and batch: loss rtol 2e-5, gradient norm rtol
    2e-4."""
    results = [r[("train", size, mode)][0] for r in ranks["ranks"][mesh]]
    assert all(m == results[0] for m in results)
    got, want = results[0], ranks["jax"][("train", size, mode)]
    for key in ("loss", "cls_loss", "reg_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GRAD_NORM_RTOL)
    assert got["reg_loss"] > 0 and got["grad_norm"] > 0


def _assert_grads_close(got, want, rtol):
    """Each gradient within ``rtol`` of its tensor's largest (of the
    largest of all where a tensor's is below 1e-4 of it)."""
    assert got.keys() == want.keys()
    largest = max(np.abs(g).max() for g in want.values())
    for key, w in want.items():
        top = np.abs(w).max()
        scale = top if top > 1e-4 * largest else largest
        err = np.abs(got[key] - w).max()
        assert err <= rtol * scale, (key, err, scale)


@pytest.mark.parametrize("mesh,size,mode", CASES)
def test_spatial_step_matches_one_process(ranks, mesh, size, mode):
    """The gradient the ranks apply (summed over the ranks, divided by the
    data width) against the port's one-process step over the whole batch:
    within ``ONE_PROCESS_GRAD_RTOL`` of each tensor's largest."""
    got = ranks["ranks"][mesh][0][("train", size, mode)][1]
    want = ranks["single"][("train", size, mode)][1]
    _assert_grads_close(got, want, ONE_PROCESS_GRAD_RTOL)


@pytest.mark.parametrize("mesh,size,mode", CASES)
def test_ranks_take_the_same_step(ranks, mesh, size, mode):
    """After the step every rank's parameters and buffers are bit-equal
    (one digest)."""
    digests = {r[("train", size, mode)][2] for r in ranks["ranks"][mesh]}
    assert len(digests) == 1


@pytest.mark.parametrize("mesh", list(MESHES))
def test_remat_and_the_real_drop_connect(ranks, mesh):
    """``remat`` with the real drop-connect (each spatial rank of an image
    draws its mask from the step's generator, sliced by data rank): the
    recomputed branches exchange again on every rank, and the step equals
    the one without ``remat`` bit for bit; both are within the bound of the
    one-process step with the same draws."""
    results = ranks["ranks"][mesh]
    for r in results:
        assert r["remat"][0] == r["real"][0]
        assert r["remat"][2] == r["real"][2]
    assert len({r["real"][2] for r in results}) == 1
    _assert_grads_close(results[0]["remat"][1], ranks["single"]["real"][1],
                        ONE_PROCESS_GRAD_RTOL)
    got, want = results[0]["real"][0], ranks["single"]["real"][0]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=GRAD_NORM_RTOL)


def _assert_detections_close(got, want):
    scores, classes, boxes, valid = got
    w_scores, w_classes, w_boxes, w_valid = want
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_array_equal(classes, w_classes)
    np.testing.assert_allclose(scores, w_scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(boxes, w_boxes, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mesh,size", [(m, s) for m in MESHES
                                       for s in SIZES])
def test_spatial_serving_matches_jax(ranks, mesh, size):
    """Every rank gets the global batch's detections, equal on all ranks,
    within JAX's serving tolerances of JAX's ``make_eval_step`` and of the
    port's one-process eval step."""
    dets = [r[("eval", size)] for r in ranks["ranks"][mesh]]
    for d in dets[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(d, dets[0]))
    _assert_detections_close(dets[0], ranks["jax"][("eval", size)])
    _assert_detections_close(dets[0], ranks["single"][("eval", size)])
    assert dets[0][3].sum() > 20


@pytest.mark.parametrize("name", list(EXCHANGE_OPS))
def test_exchange_backward_sums_to_the_whole_gradient(ranks, name):
    """Over two gloo ranks: the bands' input gradients put together, and
    the ranks' parameter gradients summed, equal the whole op's gradients
    (float32 sums in another order: 1e-5)."""
    rows, conv, op = _exchange_op(name)
    x = _exchange_inputs(name, rows).requires_grad_()
    y = op(x)
    params = [] if conv is None else [conv.weight, conv.bias]
    want = torch.autograd.grad(y, [x] + params, _exchange_grad(y.shape))
    parts = [r["exchange"][name] for r in ranks["ranks"]["1x2"]]
    got_x = np.concatenate([p[0] for p in parts], axis=2)
    np.testing.assert_allclose(got_x, want[0].numpy(), rtol=1e-5, atol=1e-5)
    for i, w in enumerate(want[1:], start=1):
        np.testing.assert_allclose(sum(p[i] for p in parts), w.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_refusals_under_the_group(ranks):
    """On every rank: the fused backbone refuses the spatial axis, from a
    sharded eval step and from ``fused_backbone_forward``, naming A17;
    ``num_data x num_spatial`` other than the world size raises."""
    for name in MESHES:
        for r in ranks["ranks"][name]:
            fused_step, fused_forward, mismatch = r["refusals"]
            assert fused_step == fused_forward == SPATIAL_REFUSAL
            assert "A17" in SPATIAL_REFUSAL
            assert "WORLD_SIZE" in mismatch


# ---------------------------------------------------------------- driver
@pytest.fixture(scope="module")
def driver_runs(background):
    """Run A (``--num_devices 1 --spatial_shards 2``, two epochs) and run O
    (one process), both started in ``background``; run B: ``driver.main``
    resuming A's first blob, spatially."""
    tmp, procs = background
    for run in ("a", "o"):
        _wait(procs[run], tmp / f"driver_{run}.log")
    with pytest.MonkeyPatch.context() as mp:
        for key in LAUNCHER_VARS:
            mp.delenv(key, raising=False)
        mp.setenv("OMP_NUM_THREADS", "1")
        resumed = driver.main(DRIVER_ARGV + SPATIAL_ARGV + [
            "--save_folder", str(tmp / "b"), "--resume",
            str(tmp / "a" / "synthetic" / "efficientdet-d0" /
                "checkpoint_0.pth")])
    return {"stdout": (tmp / "driver_a.log").read_text(), "out": tmp,
            "resumed": resumed,
            "records": [json.loads(line) for line in
                        open(tmp / "log_a" / "metrics.jsonl")]}


def _blob(path):
    return torch.load(path, weights_only=False)


def test_driver_spatial_start_line(driver_runs):
    """One setup line for the two ranks, in the JAX driver's form."""
    assert driver_runs["stdout"].count(
        "devices: 1 data x 2 spatial | processes: 2 | global batch: 2 | "
        "per-process: 2") == 1


def test_driver_spatial_rank0_alone_writes(driver_runs):
    """Rank 0 alone prints, logs and saves: one line per epoch, two
    checkpoints, one metrics record per step (one step an epoch)."""
    stdout = driver_runs["stdout"]
    assert stdout.count("saved checkpoint -> ") == 2
    assert stdout.count(" done: loss ") == 2
    folder = driver_runs["out"] / "a" / "synthetic" / "efficientdet-d0"
    assert sorted(os.listdir(folder)) == ["checkpoint_0.pth",
                                          "checkpoint_1.pth"]
    records = driver_runs["records"]
    assert sum("loss" in r for r in records) == 2
    assert sum("val_loss" in r for r in records) == 2


# The bound between world sizes after AdamW steps (test_torch_port_
# parallel.INVARIANCE_PARAM_ATOL): a quarter of lr per step, over the run's
# 2 steps; the epoch losses to float32 noise.
DRIVER_PARAM_ATOL = 0.25 * 1e-4 * 2
DRIVER_LOSS_RTOL = 1e-5


def test_driver_spatial_blob_matches_one_process(driver_runs):
    """The spatial run's last blob against one process's: every parameter
    and statistic within ``DRIVER_PARAM_ATOL``, the epoch losses within
    float32 noise."""
    folder = lambda run: driver_runs["out"] / run / "synthetic" / \
        "efficientdet-d0" / "checkpoint_1.pth"
    a, o = _blob(folder("a")), _blob(folder("o"))
    for key, value in o["state_dict"].items():
        np.testing.assert_allclose(a["state_dict"][key].float().numpy(),
                                   value.float().numpy(), rtol=0,
                                   atol=DRIVER_PARAM_ATOL, err_msg=key)
    logs = [[r["epoch_loss"] for r in map(json.loads, open(
        driver_runs["out"] / f"log_{run}" / "metrics.jsonl"))
        if "epoch_loss" in r] for run in ("a", "o")]
    np.testing.assert_allclose(logs[0], logs[1], rtol=DRIVER_LOSS_RTOL)


def test_driver_spatial_resume_continues_bit_equal(driver_runs):
    """``--resume`` of A's first blob at 1 x 2 runs A's epoch 1 again: the
    same epoch loss and a bit-equal last blob."""
    resumed = driver_runs["resumed"]
    assert resumed["epochs"] == [1]
    losses = [r["epoch_loss"] for r in driver_runs["records"]
              if "epoch_loss" in r]
    assert resumed["epoch_loss"][0] == losses[1]
    a = _blob(driver_runs["out"] / "a" / "synthetic" / "efficientdet-d0" /
              "checkpoint_1.pth")
    b = _blob(resumed["checkpoints"][0])
    for key, value in a["state_dict"].items():
        assert torch.equal(b["state_dict"][key], value), key


def test_jax_load_weights_reads_the_spatial_blob(driver_runs):
    """JAX's ``load_weights`` reads the blob rank 0 saved."""
    import jax

    from efficientdet_tpu.utils import checkpoint as jax_ckpt
    from efficientdet_tpu_torch.utils import checkpoint as ckpt
    from efficientdet_tpu_torch.utils.weights import to_jax_variables
    from test_torch_port_driver import _jax_template

    path = driver_runs["resumed"]["checkpoints"][0]
    template = _jax_template(20)
    got = jax_ckpt.load_weights(path, template())
    model = EfficientDet(ckpt.load_config(path), device="cpu")
    ckpt.load_weights(path, model)
    want = to_jax_variables(model, template())
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for (p, w), g in zip(leaves, jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(p))


# ------------------------------------------------------------- refusals
def test_driver_refuses_more_ranks_than_cards(tmp_path, monkeypatch):
    """NCCL with more ranks (data x spatial) than cards raises before a
    process is spawned or a file written."""
    if torch.cuda.device_count() >= 4:
        pytest.skip("this host has four cards")
    for key in LAUNCHER_VARS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="4 ranks, this host has"):
        driver.main(DRIVER_ARGV + ["--save_folder", str(tmp_path),
                                   "--num_devices", "2", "--spatial_shards",
                                   "2", "--device", "cuda"])
    assert not os.listdir(tmp_path)


def test_create_mesh_spatial_needs_processes(monkeypatch):
    """Without a launcher's environment the spatial axis has no ranks."""
    for key in LAUNCHER_VARS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        create_mesh(1, num_spatial=2, device="cpu")


# ---------------------------------------------------------------- slow
@pytest.mark.slow  # JAX's mesh compiles, as tests/test_train.py's
@pytest.mark.parametrize("data,spatial_", [(1, 4), (2, 4)])
def test_jax_spatial_step_matches_the_ports(ranks, data, spatial_):
    """JAX's own spatial step on a ``data`` x ``spatial_`` mesh, on the same
    weights, batch and masks at 128 px in ``train`` BN, against the port's
    ranks of the same data width: the loss within 2e-5. On the 1 x 4 mesh
    the gradient norm too, within 2e-4. On the 2 x 4 mesh JAX's gradient
    is not its one-device step's (ROADMAP C9: its norm is 2173.9 against
    1284.5 here, with the loss equal), while the port's 2 x 2 ranks give
    the one-device step's (``test_spatial_step_matches_jax``)."""
    import jax

    from efficientdet_tpu import parallel as jax_parallel
    from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
    from efficientdet_tpu.models import efficientnet as jax_efficientnet
    from efficientdet_tpu.train import train_lib as jax_train
    from test_torch_port_slice import CFG as JAX_CFG
    from test_torch_port_train import _grad_tx

    job = ranks["job"]
    cfg = dataclasses.replace(JAX_CFG, bn_mode="train")

    def fake_drop_connect(x, rng, rate):
        return x / (1.0 - rate) * jax.numpy.asarray(
            job["masks"][_block(rate)], x.dtype)

    mesh = jax_parallel.create_mesh(num_data=data, num_spatial=spatial_)
    tx = _grad_tx()
    variables = job["variables"]
    state = jax_parallel.put_replicated(jax_train.TrainState(
        step=jax.numpy.zeros((), jax.numpy.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx), mesh)
    step = jax_parallel.shard_train_step(
        jax_train.make_train_step(JaxEfficientDet(config=cfg), cfg), mesh)
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_efficientnet, "drop_connect", fake_drop_connect)
            metrics = step(state, jax_parallel.put_batch(job["batch"][128],
                                                         mesh),
                           jax.random.PRNGKey(SEED))[1]
    finally:
        jax.config.update("jax_default_matmul_precision", None)
    got = ranks["ranks"][f"{data}x2"][0][("train", 128, "train")][0]
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                               rtol=LOSS_RTOL)
    if data == 1:
        np.testing.assert_allclose(got["grad_norm"],
                                   float(metrics["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)


if __name__ == "__main__":
    if sys.argv[2] == "jax":
        _jax_worker(sys.argv[1], int(sys.argv[3]), sys.argv[4])
    else:
        _worker(sys.argv[1], sys.argv[2])
