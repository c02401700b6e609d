"""The port's data parallelism (``efficientdet_tpu_torch.parallel`` and the
training driver's ``--num_devices``) against the JAX package's mesh, on the
CPU.

Two ranks are two processes of this file (its ``__main__`` block is the
rank worker) in a gloo group met through a ``file://`` rendezvous; they
import no jax and write their results for the test to read. The small
detector of ``test_torch_port_slice.py`` (128 px, W_bifpn 16, D_bifpn 1, 4
classes) from the same JAX variables on both sides. Checked:

- one step of ``efficientdet_tpu.parallel.shard_train_step`` on a 2-device
  mesh against the port's two ranks, in ``frozen`` and ``train`` BN, with
  drop-connect patched to the same numpy masks (each rank its strided
  slice): metrics, every parameter gradient and the ``batch_stats``, to
  ``test_torch_port_train.py``'s tolerances (the gradients against the JAX
  mesh to a looser one, ``JAX_MESH_GRAD_RTOL``, for the reason given
  there), and the gradients against the port's one-process step;
- a ``train``-mode BatchNorm over two ranks against one over their joined
  batch, forward and backward, float32 and bfloat16;
- world-size invariance: two AdamW steps at world 2 and at world 1 on the
  same global batches in loader order, with the real drop-connect and
  ``train`` BN, and at world 2 with ``remat``;
- ``shard_eval_step`` at world 2 against ``make_eval_step`` on the whole
  batch and against JAX's ``shard_eval_step``;
- ``put_replicated`` making differently seeded ranks equal;
- the driver at ``--num_devices 2``: rank 0 alone prints, logs and saves,
  ``main`` returns its summary, a resume continues bit-equal, JAX's
  ``load_weights`` reads the blob;
- the refusals: more ranks than cards (data, and data x spatial),
  ``--multihost`` without a launcher, a global batch that does not divide,
  and ``bn_mode='sync'`` training in both packages.

JAX runs at ``highest`` matmul precision and is imported inside the tests.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from efficientdet_tpu_torch import (DetectorConfig, EfficientDet,
                                    create_train_state, make_eval_step,
                                    make_train_step, to_device)
from efficientdet_tpu_torch.data import DataLoader, SyntheticDetection, collate
from efficientdet_tpu_torch.models import efficientnet as pt_efficientnet
from efficientdet_tpu_torch.models.layers import (SYNC_REFUSAL, BatchNorm,
                                                  drop_connect)
from efficientdet_tpu_torch.parallel import (create_mesh, put_replicated,
                                             shard_eval_step, shard_train_step)
from efficientdet_tpu_torch.train import driver, set_learning_rate
from efficientdet_tpu_torch.train.train_lib import step_generator
from efficientdet_tpu_torch.utils.weights import load_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128
WORLD = 2
SEED = 7
TOTAL_BLOCKS = 16  # efficientnet-b0
# test_torch_port_slice.CFG, built from the port's own configuration.
CFG = DetectorConfig(num_classes=4, network="efficientdet-d0",
                     input_size=SIZE, W_bifpn=16, D_bifpn=1, D_class=1,
                     head_stacked_convs=1, head_feat_channels=16).resolve()
MODES = ["frozen", "train"]
INVARIANCE_STEPS = 2
# World 2 against world 1 after two AdamW steps at lr 1e-4: the BN
# statistics and the gradient mean are summed in another order, and Adam's
# first steps move each weight by about lr whatever its gradient's size, so
# a weight whose gradient is near 0 (the bias of blocks 0 and 1's last BN
# is 0 in exact arithmetic) takes its rounding as a step of up to lr. The
# weights are held to a quarter of the distance the two steps can move one
# (measured: 3.3e-5 at most, 35 of 388 tensors beyond 1e-6), the losses and
# gradient norms to float32 noise.
INVARIANCE_PARAM_ATOL = 0.25 * 1e-4 * INVARIANCE_STEPS
INVARIANCE_LOSS_RTOL = 1e-5


def _block(rate):
    return int(round(rate * TOTAL_BLOCKS / 0.2))


def _port_model(variables, bn_mode="frozen", remat=False):
    model = EfficientDet(dataclasses.replace(CFG, bn_mode=bn_mode),
                         remat=remat, device="cpu")
    load_jax_variables(model, variables)
    return model.to(memory_format=torch.channels_last)


def _rows(batch, rank, world):
    """Rank ``rank``'s share of a global batch: rows rank, rank + world, ...
    (the loader's split)."""
    return {k: v[rank::world] for k, v in batch.items()}


def _numpy(tensors):
    return {k: v.detach().float().numpy() for k, v in tensors.items()}


# ------------------------------------------------------------ rank cases
def _jax_case(job, mode, mesh):
    """One sharded step from the JAX variables, drop-connect patched to the
    job's masks -> (metrics, {parameter: gradient}, running statistics)."""
    model = _port_model(job["variables"], mode)
    cfg = dataclasses.replace(CFG, bn_mode=mode)
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
    pt_efficientnet.drop_connect = fake_drop_connect
    try:
        step = shard_train_step(make_train_step(model, cfg), mesh)
        metrics = step(state, to_device(
            _rows(job["batch"], mesh.rank, mesh.world_size), "cpu"), SEED)
    finally:
        pt_efficientnet.drop_connect = real
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return ({k: float(v) for k, v in metrics.items()}, _numpy(grads),
            _numpy(stats))


def _bn_case(x, g, dtype, mesh):
    """A ``train``-mode BatchNorm on the rank's rows of ``x`` (N, C, H, W)
    with upstream gradient ``g``: output, input gradient, weight and bias
    gradients and running statistics, float32."""
    bn = BatchNorm(x.shape[1], mode="train", device="cpu").train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    bn.group = mesh.group
    xs = torch.from_numpy(x[mesh.rank::mesh.world_size]).to(dtype)
    xs.requires_grad_()
    y = bn(xs)
    dx, dw, db = torch.autograd.grad(
        y, [xs, bn.weight, bn.bias],
        torch.from_numpy(g[mesh.rank::mesh.world_size]).to(dtype))
    return {"y": y, "dx": dx, "dw": dw, "db": db, "mean": bn.running_mean,
            "var": bn.running_var}


def _bn_inputs():
    rng = np.random.RandomState(13)
    x = (rng.randn(4, 6, 5, 5) * 2 + 1).astype(np.float32)
    g = rng.randn(4, 6, 5, 5).astype(np.float32)
    return x, g


def _invariance_run(variables, mesh, remat=False):
    """``INVARIANCE_STEPS`` AdamW steps of ``train``-mode BN with the real
    drop-connect on the loader's first global batches (4 images), the
    rank's share of each -> (metrics per step, final state_dict)."""
    cfg = dataclasses.replace(CFG, bn_mode="train")
    model = _port_model(variables, "train", remat)
    state = create_train_state(model)
    step = shard_train_step(make_train_step(model, cfg), mesh)
    loader = DataLoader(
        SyntheticDetection(length=8, image_size=SIZE, num_classes=4,
                           seed=5), 4 // mesh.world_size, max_boxes=8,
        seed=3, shard_index=mesh.rank, num_shards=mesh.world_size,
        uint8_images=True)
    metrics = []
    for batch in loader:
        metrics.append({k: float(v) for k, v in step(
            state, to_device(batch, "cpu"), SEED).items()})
        if len(metrics) == INVARIANCE_STEPS:
            break
    return metrics, _numpy(model.state_dict())


def _eval_case(variables, images, mesh):
    """``shard_eval_step`` with the rank's contiguous slice of ``images``
    -> the gathered Detections as numpy."""
    model = _port_model(variables).eval()
    b = images.shape[0] // mesh.world_size
    det = shard_eval_step(make_eval_step(model, CFG), mesh)(
        torch.from_numpy(images[mesh.rank * b:(mesh.rank + 1) * b]))
    return [t.numpy() for t in det]


def _snapshot(state):
    from chip_smoke import train_state_snapshot
    return train_state_snapshot(state)


def _replicate_case(mesh):
    """Rank r builds the model from seed 100 + r and takes r + 1 plain
    steps at learning rate (r + 1) x 1e-4 -> (its snapshot, the snapshot
    after ``put_replicated``)."""
    model = EfficientDet(CFG, device="cpu",
                         generator=torch.Generator().manual_seed(
                             100 + mesh.rank))
    state = create_train_state(model)
    set_learning_rate(state.optimizer, 1e-4 * (mesh.rank + 1))
    ds = SyntheticDetection(length=2, image_size=SIZE, num_classes=4,
                            seed=mesh.rank)
    batch = to_device(collate([ds[0], ds[1]], max_boxes=8,
                              uint8_images=True), "cpu")
    step = make_train_step(model, CFG)
    for _ in range(mesh.rank + 1):
        step(state, batch, SEED)
    before = _snapshot(state)
    put_replicated(state, mesh)
    return before, _snapshot(state)


def _worker(tmp):
    """One rank: every case of the job in ``tmp``, results to
    ``tmp/rank{r}.pkl``."""
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    mesh = create_mesh(WORLD, device="cpu",
                       init_method="file://" + os.path.join(tmp, "rendezvous"))
    try:
        out = {mode: _jax_case(job, mode, mesh) for mode in MODES}
        out["bn"] = {str(dtype): _numpy(_bn_case(*_bn_inputs(), dtype, mesh))
                     for dtype in (torch.float32, torch.bfloat16)}
        out["invariance"] = _invariance_run(job["variables"], mesh)
        out["remat"] = _invariance_run(job["variables"], mesh, remat=True)
        out["eval"] = _eval_case(job["variables"], job["eval_images"], mesh)
        out["replicated"] = _replicate_case(mesh)
    finally:
        mesh.close()
    with open(os.path.join(tmp, f"rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def jax_side():
    """JAX at highest precision, the small detector's variables, the batch
    (image 1 without GT), the masks and the eval images."""
    import jax
    import jax.numpy as jnp

    from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
    from test_torch_port_slice import CFG as JAX_CFG
    from test_torch_port_slice import _random_variables

    jax.config.update("jax_default_matmul_precision", "highest")
    shapes = jax.eval_shape(JaxEfficientDet(config=JAX_CFG).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    ds = SyntheticDetection(length=4, image_size=SIZE, num_classes=4,
                            max_objects=4, seed=3)
    batch = collate([ds[i] for i in range(4)], max_boxes=8,
                    uint8_images=True)
    batch["annotations"][1] = -1.0
    rng = np.random.RandomState(11)
    job = {"variables": _random_variables(shapes, np.random.RandomState(0)),
           "batch": batch,
           "masks": [(rng.rand(4, 1, 1, 1) < 0.7).astype(np.float32)
                     for _ in range(TOTAL_BLOCKS)],
           "eval_images": np.random.RandomState(12).randint(
               0, 256, size=(4, SIZE, SIZE, 3)).astype(np.uint8)}
    yield JAX_CFG, job
    jax.config.update("jax_default_matmul_precision", None)


DRIVER_ARGV = ["--dataset", "synthetic", "--device", "cpu", "--input_size",
               str(SIZE), "--batch_size", "4", "--synthetic_length", "8",
               "--num_epoch", "2", "--eval_every", "1", "--log_every", "1",
               "--seed", "3", "--num_devices", "2"]
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")


def _start(argv, log, **env):
    """A child process writing to ``log``, with the launcher variables of
    ``env`` only, and one intra-op thread: beside the other test workers,
    more spin in their thread barriers."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS} | {
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH",
                                                            "")])} | env
    with open(log, "w") as out:
        return subprocess.Popen([sys.executable] + argv, cwd=ROOT, env=env,
                                stdout=out, stderr=subprocess.STDOUT)


def _wait(proc, log, timeout=900):
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, open(log).read()[-3000:]


@pytest.fixture(scope="module")
def background(jax_side, tmp_path_factory):
    """What runs while JAX compiles: the two rank workers on the job, and
    the driver's run A at ``--num_devices 2``."""
    _, job = jax_side
    tmp = tmp_path_factory.mktemp("parallel")
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    procs = [_start([os.path.abspath(__file__), str(tmp)],
                    tmp / f"rank{rank}.log", RANK=str(rank),
                    WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                    LOCAL_WORLD_SIZE=str(WORLD))
             for rank in range(WORLD)]
    procs.append(_start(
        ["-m", "efficientdet_tpu_torch.train"] + DRIVER_ARGV
        + ["--save_folder", str(tmp / "a"), "--log_dir", str(tmp / "log")],
        tmp / "driver.log"))
    yield tmp, procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _jax_sharded_steps(jax_cfg, job):
    """``efficientdet_tpu.parallel.shard_train_step`` on a 2-device mesh per
    BN mode, drop-connect patched to the job's masks, with an optimizer
    that keeps the raw gradients as its state -> (metrics, gradients,
    batch_stats)."""
    import jax
    from flax.core import unfreeze

    from efficientdet_tpu import parallel as jax_parallel
    from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
    from efficientdet_tpu.models import efficientnet as jax_efficientnet
    from efficientdet_tpu.train import train_lib as jax_train
    from test_torch_port_train import _grad_tx

    def fake_drop_connect(x, rng, rate):
        return x / (1.0 - rate) * jax.numpy.asarray(
            job["masks"][_block(rate)], x.dtype)

    mesh = jax_parallel.create_mesh(num_data=WORLD,
                                    devices=jax.devices()[:WORLD])
    variables = job["variables"]
    out = {}
    for mode in MODES:
        cfg = dataclasses.replace(jax_cfg, bn_mode=mode)
        tx = _grad_tx()
        state = jax_parallel.put_replicated(jax_train.TrainState(
            step=jax.numpy.zeros((), jax.numpy.int32),
            params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=tx.init(variables["params"]), tx=tx), mesh)
        step = jax_parallel.shard_train_step(
            jax_train.make_train_step(JaxEfficientDet(config=cfg), cfg), mesh)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_efficientnet, "drop_connect", fake_drop_connect)
            new_state, metrics = step(
                state, jax_parallel.put_batch(job["batch"], mesh),
                jax.random.PRNGKey(SEED))
        to_np = lambda tree: jax.tree.map(np.asarray, unfreeze(tree))
        out[mode] = ({k: float(v) for k, v in metrics.items()},
                     to_np(new_state.opt_state),
                     to_np(new_state.batch_stats))
    return out


def _jax_sharded_eval(jax_cfg, job):
    import jax

    from efficientdet_tpu import parallel as jax_parallel
    from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
    from efficientdet_tpu.train import make_eval_step as jax_make_eval_step

    mesh = jax_parallel.create_mesh(num_data=WORLD,
                                    devices=jax.devices()[:WORLD])
    step = jax_parallel.shard_eval_step(
        jax_make_eval_step(JaxEfficientDet(config=jax_cfg), jax_cfg), mesh)
    det = step(jax_parallel.put_replicated(job["variables"], mesh),
               jax_parallel.put_batch({"x": job["eval_images"]}, mesh)["x"])
    return [np.asarray(t) for t in det]


@pytest.fixture(scope="module")
def ranks(jax_side, background):
    """The two ranks' results, JAX's and the one-process references."""
    jax_cfg, job = jax_side
    tmp, procs = background
    jax_out = _jax_sharded_steps(jax_cfg, job)
    jax_eval = _jax_sharded_eval(jax_cfg, job)
    one = create_mesh(device="cpu")
    single = {mode: _jax_case(job, mode, one) for mode in MODES}
    single["invariance"] = _invariance_run(job["variables"], one)
    single["eval"] = [t.numpy() for t in make_eval_step(
        _port_model(job["variables"]).eval(), CFG)(
            torch.from_numpy(job["eval_images"]))]
    got = []
    for rank in range(WORLD):
        _wait(procs[rank], tmp / f"rank{rank}.log")
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return {"ranks": got, "jax": jax_out, "jax_eval": jax_eval,
            "single": single, "job": job}


# ------------------------------------------------- (a) against JAX's mesh


@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_metrics_match_jax(ranks, mode):
    """Both ranks report the global metrics, equal to each other and to
    JAX's mesh step within 1e-4."""
    (m0, _, _), (m1, _, _) = (r[mode] for r in ranks["ranks"])
    want, _, _ = ranks["jax"][mode]
    assert m0 == m1
    assert set(m0) == set(want) == {"loss", "cls_loss", "reg_loss",
                                    "grad_norm"}
    for key, value in want.items():
        np.testing.assert_allclose(m0[key], value, rtol=1e-4, err_msg=key)
    assert m0["reg_loss"] > 0 and m0["grad_norm"] > 0


# The port's two ranks against JAX's 2-device mesh: 3e-4 of each tensor's
# largest gradient, looser than test_torch_port_train's 1e-4 because JAX's
# own mesh step on the CPU differs from its one-device step on these inputs
# by up to 1.8e-4 of a tensor's largest gradient (frozen BN), while the
# port at world 1 and 2 agrees with the one-device step within 3e-6. The
# port's two ranks against its own one-process step: test_torch_port_train's
# 1e-4 (frozen BN agrees within 2e-6; in train BN the ranks take the
# statistics from all-reduced sums, one process inside torch.batch_norm).
JAX_MESH_GRAD_RTOL = 3e-4
ONE_PROCESS_GRAD_RTOL = 1e-4


@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_gradients_match_jax(ranks, mode):
    """The gradient each rank applies is the global one: bit-equal on the
    two ranks, within ``ONE_PROCESS_GRAD_RTOL`` of each tensor's largest
    of the port's one-process step over the whole batch, and within
    ``JAX_MESH_GRAD_RTOL`` (+ 1e-7) of JAX's mesh step; in ``train`` BN the
    gradients that are 0 in exact arithmetic (test_torch_port_train's
    ``STRUCTURAL_ZERO``) are below 1e-4 of the largest."""
    import jax

    from efficientdet_tpu.utils.torch_import import import_efficientdet
    from test_torch_port_train import STRUCTURAL_ZERO

    (_, g0, _), (_, g1, _) = (r[mode] for r in ranks["ranks"])
    _, one, _ = ranks["single"][mode]
    _, want, _ = ranks["jax"][mode]
    assert g0.keys() == g1.keys() == one.keys()
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)
    largest = max(np.abs(g).max() for g in one.values())
    for key, g in one.items():
        scale = largest if np.abs(g).max() <= 1e-4 * largest else \
            np.abs(g).max()
        assert np.abs(g0[key] - g).max() <= ONE_PROCESS_GRAD_RTOL * scale, key
    got = import_efficientdet({k: torch.from_numpy(v) for k, v in g0.items()},
                              {"params": jax.tree.map(np.zeros_like, want)}
                              )["params"]
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(g0)
    largest = max(np.abs(w).max() for _, w in leaves)
    for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        if mode == "train" and name in STRUCTURAL_ZERO:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-4 * largest
            continue
        err = np.abs(g - w).max()
        assert err <= JAX_MESH_GRAD_RTOL * np.abs(w).max() + 1e-7, (
            name, err, np.abs(w).max())


@pytest.mark.parametrize("mode", MODES)
def test_sharded_step_batch_stats_match_jax(ranks, mode):
    """``train`` BN moves the running statistics by the global batch's
    statistics, as JAX's mesh does (within 1e-5), equally on both ranks;
    ``frozen`` leaves them bit-equal."""
    import jax
    from flax.core import unfreeze

    from efficientdet_tpu.utils.torch_import import import_efficientdet

    (_, _, s0), (_, _, s1) = (r[mode] for r in ranks["ranks"])
    _, _, want = ranks["jax"][mode]
    assert all(np.array_equal(s0[k], s1[k]) for k in s0)
    variables = ranks["job"]["variables"]
    fresh = jax.tree.map(np.zeros_like, unfreeze(variables))
    got = import_efficientdet({k: torch.from_numpy(v) for k, v in s0.items()},
                              fresh)["batch_stats"]
    before = jax.tree_util.tree_leaves(variables["batch_stats"])
    for g, w, b in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(want), before):
        if mode == "frozen":
            np.testing.assert_array_equal(g, b)
            np.testing.assert_array_equal(w, b)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            assert not np.array_equal(g, b)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_batchnorm_takes_global_statistics(ranks, dtype):
    """Two ranks' ``train`` BatchNorm equals one over their joined batch:
    outputs, input gradients (the backward all-reduce), the sum of the
    ranks' weight and bias gradients, and the running statistics (equal on
    both ranks). float32 within 1e-5; bfloat16 outputs and input gradients
    within one bf16 ulp of each value, since both sides round their
    float32 results to bf16."""
    x, g = _bn_inputs()
    dt = getattr(torch, dtype.split(".")[1])
    bn = BatchNorm(x.shape[1], mode="train", device="cpu").train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    y = bn(xt)
    dx, dw, db = torch.autograd.grad(y, [xt, bn.weight, bn.bias],
                                     torch.from_numpy(g).to(dt))
    r0, r1 = (r["bn"][dtype] for r in ranks["ranks"])
    for key in ("mean", "var"):
        assert np.array_equal(r0[key], r1[key])
    tol = (dict(rtol=1e-5, atol=1e-5) if dt == torch.float32 else
           dict(rtol=2.0 ** -7, atol=0))
    for key, want in (("y", y), ("dx", dx)):
        want = want.detach().float().numpy()
        joined = np.empty_like(want)
        joined[0::2], joined[1::2] = r0[key], r1[key]
        np.testing.assert_allclose(joined, want, **tol, err_msg=key)
    for key, want in (("dw", dw), ("db", db)):
        np.testing.assert_allclose(r0[key] + r1[key], want.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(r0["mean"], bn.running_mean.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r0["var"], bn.running_var.numpy(),
                               rtol=1e-5, atol=1e-6)


# -------------------------------------------------- (b) world-size invariance
def test_ranks_stay_bit_equal(ranks):
    """After two AdamW steps every parameter and buffer is bit-equal on the
    two ranks, and so are the metrics of each step."""
    (m0, s0), (m1, s1) = (r["invariance"] for r in ranks["ranks"])
    assert m0 == m1 and len(m0) == INVARIANCE_STEPS
    assert s0.keys() == s1.keys()
    for key in s0:
        assert np.array_equal(s0[key], s1[key]), key


def test_world_two_matches_one_process(ranks):
    """Two ranks at global batch 4 take the one-process step at batch 4:
    losses within ``INVARIANCE_LOSS_RTOL`` at every step, the parameters
    and running statistics within ``INVARIANCE_PARAM_ATOL``, and the
    training moved them."""
    m2, s2 = ranks["ranks"][0]["invariance"]
    m1, s1 = ranks["single"]["invariance"]
    for got, want in zip(m2, m1):
        for key in ("loss", "cls_loss", "reg_loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key],
                                       rtol=INVARIANCE_LOSS_RTOL, err_msg=key)
    variables = ranks["job"]["variables"]
    start = _numpy(_port_model(variables, "train").state_dict())
    moved = 0
    for key, want in s1.items():
        np.testing.assert_allclose(s2[key], want, rtol=0,
                                   atol=INVARIANCE_PARAM_ATOL, err_msg=key)
        moved += not np.array_equal(want, start[key])
    assert moved > len(s1) // 2


def test_remat_under_the_group_takes_the_same_steps(ranks):
    """``remat`` at world 2: each recomputed MBConv branch runs its
    BatchNorms' all-reduce again on both ranks (and does not move their
    statistics again), so the two steps equal those without ``remat``: the
    metrics and every parameter and buffer bit-equal."""
    for rank in ranks["ranks"]:
        (m0, s0), (m1, s1) = rank["invariance"], rank["remat"]
        assert m1 == m0
        for key in s0:
            assert np.array_equal(s1[key], s0[key]), key


# --------------------------------------------------- (c) shard_eval_step
def test_shard_eval_step_matches_make_eval_step(ranks):
    """Both ranks get the whole batch's detections, equal to each other and
    to ``make_eval_step`` on the whole batch (test_train.py's mesh
    tolerances: classes and valid equal, scores rtol 1e-5 atol 1e-6, boxes
    rtol 1e-5 atol 1e-4)."""
    d0, d1 = (r["eval"] for r in ranks["ranks"])
    want = ranks["single"]["eval"]
    assert all(np.array_equal(a, b) for a, b in zip(d0, d1))
    _assert_detections_close(d0, want)
    assert d0[3].sum() > 20


def test_shard_eval_step_matches_jax(ranks):
    """The gathered detections against JAX's ``shard_eval_step`` on a
    2-device mesh, to the same tolerances."""
    _assert_detections_close(ranks["ranks"][0]["eval"], ranks["jax_eval"])


def _assert_detections_close(got, want):
    scores, classes, boxes, valid = got
    w_scores, w_classes, w_boxes, w_valid = want
    np.testing.assert_array_equal(valid, w_valid)
    np.testing.assert_array_equal(classes, w_classes)
    np.testing.assert_allclose(scores, w_scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(boxes, w_boxes, rtol=1e-5, atol=1e-4)


# --------------------------------------------------- (f) put_replicated
def test_put_replicated_makes_ranks_equal(ranks):
    """Ranks seeded differently, with other step counts and learning rates,
    all hold rank 0's state after ``put_replicated``: weights, statistics,
    Adam's moments and counts, learning rate and step."""
    from chip_smoke import check_snapshots_equal

    (b0, a0), (b1, a1) = (r["replicated"] for r in ranks["ranks"])
    assert not torch.equal(b0["model"]["backbone._conv_stem.weight"],
                           b1["model"]["backbone._conv_stem.weight"])
    assert b0["counts"] != b1["counts"] and b0["lr"] != b1["lr"]
    for after in (a0, a1):
        assert check_snapshots_equal(torch, after, b0) > len(b0["model"])


# --------------------------------------------------------- drop-connect
def test_drop_connect_shards_are_the_global_draw():
    """Each rank's masks, drawn from the step's generator with its shard,
    are the global draw's rows rank, rank + world, ...; (0, 1) draws what
    a one-process step draws."""
    x = torch.ones(6, 2, 3, 3)
    full = torch.ones(12, 2, 3, 3)
    want = drop_connect(full, 0.3, step_generator(1, 4, x.device))
    assert torch.equal(want, drop_connect(full, 0.3, step_generator(
        1, 4, x.device), (0, 1)))
    got = torch.empty_like(want)
    for rank in range(WORLD):
        got[rank::WORLD] = drop_connect(
            x, 0.3, step_generator(1, 4, x.device), (rank, WORLD))
    assert torch.equal(got, want)
    assert 0 < int((want == 0).all(dim=(1, 2, 3)).sum()) < 12


# ------------------------------------------------------------- (d) driver
@pytest.fixture(scope="module")
def driver_runs(background):
    """Run A (started in ``background``): ``python -m
    efficientdet_tpu_torch.train --num_devices 2`` for two epochs; run B:
    ``driver.main`` resuming from A's first blob."""
    tmp, procs = background
    _wait(procs[WORLD], tmp / "driver.log")
    with pytest.MonkeyPatch.context() as mp:
        for key in LAUNCHER_VARS:
            mp.delenv(key, raising=False)
        mp.setenv("OMP_NUM_THREADS", "1")
        resumed = driver.main(DRIVER_ARGV + [
            "--save_folder", str(tmp / "b"), "--resume",
            str(tmp / "a" / "synthetic" / "efficientdet-d0" /
                "checkpoint_0.pth")])
    records = [json.loads(line) for line in open(tmp / "log" /
                                                 "metrics.jsonl")]
    return {"stdout": (tmp / "driver.log").read_text(), "records": records,
            "resumed": resumed, "out": tmp}


def test_driver_two_ranks_rank0_prints_logs_and_saves(driver_runs):
    """One setup line for two ranks, one line per step and epoch, two
    checkpoints, and the metric records of one process."""
    stdout = driver_runs["stdout"]
    assert stdout.count("devices: 2 data x 1 spatial | processes: 2 | "
                        "global batch: 4 | per-process: 2") == 1
    assert stdout.count("saved checkpoint -> ") == 2
    assert stdout.count(" done: loss ") == 2
    folder = driver_runs["out"] / "a" / "synthetic" / "efficientdet-d0"
    assert sorted(os.listdir(folder)) == ["checkpoint_0.pth",
                                          "checkpoint_1.pth"]
    records = driver_runs["records"]
    assert [r["epoch"] for r in records if "epoch" in r] == [0, 1]
    assert sum("loss" in r for r in records) == 4  # 2 global steps an epoch
    assert sum("val_loss" in r for r in records) == 2
    assert all(np.isfinite(r.get("epoch_loss", 0.0)) for r in records)


def test_driver_two_ranks_resume_continues_bit_equal(driver_runs):
    """``main`` returns rank 0's summary (its checkpoint list) after
    spawning, and the resumed epoch 1 is run A's: the same epoch loss and
    a bit-equal final blob."""
    resumed = driver_runs["resumed"]
    assert resumed["epochs"] == [1]
    assert [os.path.basename(p) for p in resumed["checkpoints"]] == [
        "checkpoint_1.pth"]
    losses = [r["epoch_loss"] for r in driver_runs["records"]
              if "epoch_loss" in r]
    assert resumed["epoch_loss"][0] == losses[1]
    a = torch.load(driver_runs["out"] / "a" / "synthetic" /
                   "efficientdet-d0" / "checkpoint_1.pth", weights_only=False)
    b = torch.load(resumed["checkpoints"][0], weights_only=False)
    for key, value in a["state_dict"].items():
        assert torch.equal(b["state_dict"][key], value), key
    for i, entry in a["optimizer"]["state"].items():
        for key, value in entry.items():
            assert torch.equal(b["optimizer"]["state"][i][key], value)


def test_jax_load_weights_reads_two_rank_blob(driver_runs):
    """JAX's ``load_weights`` reads the blob rank 0 saved, to the leaves the
    port's own loader gives."""
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


# ----------------------------------------------------------- (e) refusals
REFUSALS = {
    "spatial_shards": (["--spatial_shards", "2", "--device", "cuda"],
                       ValueError, "CUDA card"),
    "more_ranks_than_cards": (["--num_devices", "2", "--device", "cuda"],
                              ValueError, "CUDA card"),
    "multihost_without_launcher": (["--multihost"], RuntimeError,
                                   "RANK, WORLD_SIZE"),
    "batch_not_divisible": (["--batch_size", "3", "--num_devices", "2"],
                            ValueError, "must divide over 2"),
    "num_devices_not_world_size": (["--num_devices", "3"], ValueError,
                                   "WORLD_SIZE is 2"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_driver_refuses(name, tmp_path, monkeypatch):
    """Each refused setting raises before a process is spawned or a file
    written."""
    extra, error, match = REFUSALS[name]
    if name in ("more_ranks_than_cards", "spatial_shards") and \
            torch.cuda.device_count() >= 2:
        pytest.skip("this host has two cards")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    if name == "num_devices_not_world_size":
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
    argv = DRIVER_ARGV[:-2] + ["--save_folder", str(tmp_path)] + extra
    with pytest.raises(error, match=match):
        driver.main(argv)
    assert not os.listdir(tmp_path)


def test_create_mesh_refusals(monkeypatch):
    """The library refuses what the driver does: spatial ranks, and data
    ranks, without processes; one process without a group changes no
    step."""
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        create_mesh(num_spatial=2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        create_mesh(num_data=2, device="cpu")
    mesh = create_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    step = make_train_step(EfficientDet(CFG, device="cpu"), CFG)
    assert shard_train_step(step, mesh) is step
    assert shard_eval_step(make_eval_step, mesh) is make_eval_step


def test_sync_bn_refuses_to_train_in_both_packages(jax_side):
    """``bn_mode='sync'``: the port's train step raises with the reason;
    JAX's jitted step fails to trace on the unbound axis 'data'."""
    import jax
    import jax.numpy as jnp

    from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
    from efficientdet_tpu.train import train_lib as jax_train

    jax_cfg, job = jax_side
    cfg = dataclasses.replace(CFG, bn_mode="sync")
    model = EfficientDet(cfg, device="cpu")
    batch = to_device(_rows(job["batch"], 0, 2), "cpu")
    with pytest.raises(NotImplementedError, match="unbound axis name"):
        make_train_step(model, cfg)(create_train_state(model), batch, SEED)
    assert "bn_mode='train'" in SYNC_REFUSAL

    sync_cfg = dataclasses.replace(jax_cfg, bn_mode="sync")
    jax_model = JaxEfficientDet(config=sync_cfg)
    variables = job["variables"]
    tx = jax_train.make_optimizer(jax_train.OptimizerConfig())
    state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx)
    with pytest.raises(NameError, match="unbound axis name: data"):
        jax.jit(jax_train.make_train_step(jax_model, sync_cfg)).lower(
            state, batch={k: v[:2] for k, v in job["batch"].items()},
            rng=jax.random.PRNGKey(0))


if __name__ == "__main__":
    _worker(sys.argv[1])
