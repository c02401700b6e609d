"""The port's training step against the JAX package, on the CPU.

The small detector of ``test_torch_port_slice.py`` (128 px, W_bifpn 16,
D_bifpn 1, one 16-wide head conv, 4 classes) takes one step of
``efficientdet_tpu.train.make_train_step`` and of the port's
``make_train_step`` from the same weights and the same uint8 batch, in
``frozen`` and in ``train`` BatchNorm mode. The JAX step runs with an
optimizer that hands back the raw gradients as its state, so every
parameter gradient is compared. Drop-connect draws from different RNGs on
the two sides, so the test patches both ``drop_connect`` functions to apply
the same numpy masks. The optimizer, ``PlateauScheduler``, ``remat`` and
the kernels' refusal of gradients are covered too. JAX runs at ``highest``
matmul precision and torch without TF32.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import unfreeze
from jax.experimental.pallas import tpu as pltpu

from efficientdet_tpu.data import SyntheticDetection, collate
from efficientdet_tpu.kernels.fusion import fuse_topdown_pallas
from efficientdet_tpu.models import EfficientDet as JaxEfficientDet
from efficientdet_tpu.train import train_lib as jax_train
from efficientdet_tpu.utils.torch_import import import_efficientdet
from efficientdet_tpu_torch import (EfficientDet, OptimizerConfig,
                                    PlateauScheduler, create_train_state,
                                    make_loss_step, make_train_step,
                                    to_device)
from efficientdet_tpu_torch.kernels import fusion, mbconv_kernel, nms_kernel
from efficientdet_tpu_torch.models import efficientnet as pt_efficientnet
from efficientdet_tpu_torch.train import (TrainState, get_learning_rate,
                                          make_optimizer, set_learning_rate)
from efficientdet_tpu_torch.utils.weights import (load_jax_variables,
                                                  to_jax_variables)
from test_torch_port_slice import CFG, SIZE, jax_model  # noqa: F401

TOTAL_BLOCKS = 16  # efficientnet-b0
SEED = 7


@pytest.fixture(scope="module", autouse=True)
def _precision():
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    jax.config.update("jax_default_matmul_precision", None)


def _batch():
    """Three uint8 images of ``SyntheticDetection``; image 1 has no GT."""
    ds = SyntheticDetection(length=3, image_size=SIZE, num_classes=4,
                            max_objects=4, seed=3)
    batch = collate([ds[i] for i in range(3)], max_boxes=8,
                    uint8_images=True)
    batch["annotations"][1] = -1.0
    return batch


def _masks(b=3):
    """One (b, 1, 1, 1) keep mask per block, some samples dropped."""
    rng = np.random.RandomState(11)
    return [(rng.rand(b, 1, 1, 1) < 0.7).astype(np.float32)
            for _ in range(TOTAL_BLOCKS)]


def _block(rate):
    return int(round(rate * TOTAL_BLOCKS / 0.2))


def _grad_tx():
    """An optimizer that leaves the parameters alone and keeps the raw
    gradients as its state, so the JAX step exposes them."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_step(variables, cfg, batch, masks):
    """One JAX train step -> (metrics, gradients, batch_stats), numpy."""
    from efficientdet_tpu.models import efficientnet as jax_efficientnet

    def fake_drop_connect(x, rng, rate):
        return x / (1.0 - rate) * jnp.asarray(masks[_block(rate)], x.dtype)

    model = JaxEfficientDet(config=cfg)
    tx = _grad_tx()
    state = jax_train.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), tx=tx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_efficientnet, "drop_connect", fake_drop_connect)
        new_state, metrics = jax.jit(jax_train.make_train_step(model, cfg))(
            state, jax.device_put(batch), jax.random.PRNGKey(SEED))
    to_np = lambda tree: jax.tree.map(np.asarray, unfreeze(tree))
    return ({k: float(v) for k, v in metrics.items()},
            to_np(new_state.opt_state), to_np(new_state.batch_stats))


def _port_model(variables, cfg, **kwargs):
    model = EfficientDet(cfg, device="cpu", **kwargs)
    load_jax_variables(model, variables)
    return model.to(memory_format=torch.channels_last)


def _port_step(model, cfg, batch, masks):
    """One port train step -> (metrics, {parameter name: raw gradient})."""
    def fake_drop_connect(x, rate, generator=None):
        return x / (1.0 - rate) * torch.from_numpy(masks[_block(rate)])

    state = create_train_state(model)
    names = [n for n, _ in model.named_parameters()]
    grads = {}
    apply = state.apply_gradients

    def capture(gs):
        grads.update((n, g.detach().clone()) for n, g in zip(names, gs))
        apply(gs)

    state.apply_gradients = capture
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt_efficientnet, "drop_connect", fake_drop_connect)
        metrics = make_train_step(model, cfg)(
            state, to_device(batch, "cpu"), SEED)
    assert state.step == 1
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.fixture(scope="module", params=["frozen", "train"])
def steps(request, jax_model):
    """Both steps from the same weights and batch in one BN mode."""
    _, variables = jax_model
    cfg = dataclasses.replace(CFG, bn_mode=request.param)
    batch, masks = _batch(), _masks()
    want = _jax_step(variables, cfg, batch, masks)
    model = _port_model(variables, cfg)
    got = _port_step(model, cfg, batch, masks)
    return request.param, variables, model, got, want


def test_train_step_metrics_match_jax(steps):
    _, _, _, (metrics, _), (want, _, _) = steps
    assert set(metrics) == {"loss", "cls_loss", "reg_loss", "grad_norm"}
    for key, value in want.items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-4,
                                   err_msg=key)
    assert metrics["reg_loss"] > 0 and metrics["grad_norm"] > 0


# In ``train`` mode the bias of the last BN of blocks 0 and 1 has a gradient
# of exactly 0 in exact arithmetic: their output reaches only train-mode
# BatchNorms (it lies before the first pyramid level), which subtract any
# per-channel shift, and they have no identity skip whose per-sample
# drop-connect mask would make the shift vary over the batch. Both sides
# hold float32 rounding noise there, which a per-tensor tolerance cannot
# scale to.
STRUCTURAL_ZERO = {f"['backbone']['block_{i}']['bn2']['bn']['bias']"
                   for i in range(2)}


def test_train_step_gradients_match_jax(steps):
    """Every parameter's gradient: max |diff| <= 1e-4 max |g| + 1e-7, and
    gradients that are 0 in exact arithmetic below 1e-4 of the largest."""
    mode, _, _, (_, grads), (_, want, _) = steps
    got = import_efficientdet(
        grads, {"params": jax.tree.map(np.zeros_like, want)})["params"]
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(leaves) == len(grads)
    largest = max(np.abs(w).max() for _, w in leaves)
    for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got)):
        name = jax.tree_util.keystr(path)
        if mode == "train" and name in STRUCTURAL_ZERO:
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-4 * largest
            continue
        err = np.abs(g - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-7, (
            name, err, np.abs(w).max())


def test_train_step_batch_stats_match_jax(steps):
    """``train`` mode moves the running statistics as flax does (within
    1e-5); ``frozen`` leaves them bit-equal."""
    mode, variables, model, _, (_, _, want) = steps
    fresh = jax.tree.map(np.zeros_like, unfreeze(variables))
    got = to_jax_variables(model, fresh)["batch_stats"]
    before = jax.tree_util.tree_leaves(variables["batch_stats"])
    for g, w, b in zip(jax.tree_util.tree_leaves(got),
                       jax.tree_util.tree_leaves(want), before):
        if mode == "frozen":
            np.testing.assert_array_equal(g, b)
            np.testing.assert_array_equal(w, b)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            assert not np.array_equal(g, b)


def test_loss_step_matches_jax(jax_model):
    """The eval-mode loss without autograd against JAX's loss step."""
    model, variables = jax_model
    batch = _batch()
    want = jax.jit(jax_train.make_loss_step(model, CFG))(
        variables, jax.device_put(batch))
    port = _port_model(variables, CFG).train()
    got = make_loss_step(port, CFG)(to_device(batch, "cpu"))
    assert not port.training and not got[0].requires_grad
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-4)


# ------------------------------------------------------------------ optimizer
def _param_arrays():
    rng = np.random.RandomState(5)
    return [rng.randn(*s).astype(np.float32) for s in ((5,), (4, 3),
                                                       (2, 3, 3))]


OPT_CASES = {
    # name: (OptimizerConfig kwargs, gradient scale, lr set before update i)
    "clipped": ({}, 1.0, {}),
    "unclipped": ({}, 0.01, {}),
    "accumulate2": ({"grad_accumulation_steps": 2}, 0.3, {}),
    "lr_change": ({"learning_rate": 1e-3}, 1.0, {1: 5e-4, 2: 2e-4}),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    """The same gradient sequence through optax (``make_optimizer``,
    ``apply_updates``) and the port's train state: parameters within 1e-6
    relative after 3 updates, and unchanged between the mini-steps of an
    accumulation."""
    kwargs, scale, lrs = OPT_CASES[case]
    cfg = OptimizerConfig(**kwargs)
    k = cfg.grad_accumulation_steps
    rng = np.random.RandomState(6)
    grads = [[(rng.randn(*p.shape) * scale).astype(np.float32)
              for p in _param_arrays()] for _ in range(3 * k)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs)) for gs in grads]
    assert all((n > cfg.grad_clip_norm) == (scale > 0.1) for n in norms)

    tx = jax_train.make_optimizer(cfg)
    params = [jnp.asarray(p) for p in _param_arrays()]
    opt_state = tx.init(params)
    port_params = [torch.from_numpy(p).requires_grad_()
                   for p in _param_arrays()]
    state = TrainState(None, make_optimizer(port_params, cfg), cfg)
    for i, gs in enumerate(grads):
        update = i // k
        if i % k == 0 and update in lrs:
            opt_state = jax_train.set_learning_rate(opt_state, lrs[update])
            set_learning_rate(state.optimizer, lrs[update])
            assert get_learning_rate(state.optimizer) == lrs[update]
        before = [p.detach().clone() for p in port_params]
        updates, opt_state = tx.update([jnp.asarray(g) for g in gs],
                                       opt_state, params)
        params = optax.apply_updates(params, updates)
        state.apply_gradients([torch.from_numpy(g) for g in gs])
        if i % k != k - 1:
            assert all(torch.equal(p, b) for p, b in zip(port_params, before))
    for got, want in zip(port_params, params):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    assert not np.allclose(np.asarray(params[0]), _param_arrays()[0])


PLATEAU_CASES = {
    # test_train.py: decay after patience, then a new best keeps the rate
    "patience": ({"factor": 0.1, "patience": 2}, 1e-4,
                 [(1.0, 1e-4, 0), (2.0, 1e-4, 1), (2.0, 1e-4, 2),
                  (2.0, 1e-5, 0), (0.5, 1e-5, 0)]),
    # test_train.py: relative threshold, and no bad epochs in cooldown
    "threshold_cooldown": (
        {"factor": 0.1, "patience": 1, "threshold": 1e-4, "cooldown": 2},
        1.0, [(1.0, 1.0, 0), (0.99995, 1.0, 1), (1.0, 0.1, 0),
              (1.0, 0.1, 0), (1.0, 0.1, 0), (1.0, 0.1, 1), (1.0, 0.01, 0)]),
}


@pytest.mark.parametrize("case", list(PLATEAU_CASES))
def test_plateau_scheduler_matches_jax(case):
    """The port's copy follows torch's ReduceLROnPlateau as the JAX
    package's does, epoch by epoch."""
    kwargs, lr, epochs = PLATEAU_CASES[case]
    port, ref = PlateauScheduler(**kwargs), jax_train.PlateauScheduler(
        **kwargs)
    ref_lr = lr
    for metric, want_lr, want_bad in epochs:
        lr = port.step(metric, lr)
        ref_lr = ref.step(metric, ref_lr)
        assert lr == pytest.approx(want_lr, rel=1e-9) and lr == ref_lr
        assert port.bad_epochs == ref.bad_epochs == want_bad
        assert port.best == ref.best


# ---------------------------------------------------------------------- remat
def test_remat_gives_the_same_gradients(jax_model):
    """``remat=True`` recomputes each MBConv branch in the backward: with
    drop-connect drawing from the same generator seed, the loss, every
    gradient and the ``train``-mode running statistics equal those without
    it (the recomputation neither draws nor moves statistics again)."""
    _, variables = jax_model
    cfg = dataclasses.replace(CFG, bn_mode="train")
    batch = _batch()
    out = []
    for remat in (False, True):
        model = _port_model(variables, cfg, remat=remat)
        state = create_train_state(model)
        grads = []
        apply = state.apply_gradients
        state.apply_gradients = lambda gs: (
            grads.extend(g.clone() for g in gs), apply(gs))
        metrics = make_train_step(model, cfg)(state, to_device(batch, "cpu"),
                                              SEED)
        out.append((metrics, grads, {k: v.clone() for k, v in
                                     model.state_dict().items()}))
    (m0, g0, s0), (m1, g1, s1) = out
    assert m0["loss"].item() == m1["loss"].item()
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)
    for key in s0:
        torch.testing.assert_close(s1[key], s0[key], rtol=0, atol=0)


# ------------------------------------------------------ kernels and autograd
def _wrapper_calls():
    """Each kernel wrapper with small CPU inputs of its contract."""
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=gen)
    cl = torch.channels_last
    mb = lambda: (r(1, 6, 6, 8), r(8, 48), r(48), r(48), r(3, 3, 48), r(48),
                  r(48))
    return {
        "fuse_topdown": (fusion.fuse_topdown,
                         (r(1, 8, 4, 4).contiguous(memory_format=cl),
                          r(1, 8, 2, 2).contiguous(memory_format=cl),
                          torch.tensor([0.4, 0.6]))),
        "fuse_bottomup": (fusion.fuse_bottomup,
                          (r(1, 8, 2, 2).contiguous(memory_format=cl),
                           r(1, 8, 4, 4).contiguous(memory_format=cl),
                           r(1, 8, 2, 2).contiguous(memory_format=cl),
                           torch.tensor([0.2, 0.3, 0.5]))),
        "fused_expand_dw": (mbconv_kernel.fused_expand_dw, mb()),
        "fused_expand_dw_flat": (mbconv_kernel.fused_expand_dw_flat, mb()),
        "nms_select": (nms_kernel.nms_select,
                       (r(1, 10), torch.cat([r(1, 10, 2) * 50,
                                             r(1, 10, 2) * 50 + 60], -1),
                        0.5, 5)),
    }


@pytest.mark.parametrize("name", ["fuse_topdown", "fuse_bottomup",
                                  "fused_expand_dw", "fused_expand_dw_flat",
                                  "nms_select"])
def test_kernel_wrappers_refuse_gradients(name):
    """A wrapper asked for a gradient raises on every device (the kernels
    have no backward); without grad mode the same call runs."""
    fn, args = _wrapper_calls()[name]
    args = [a.requires_grad_() if isinstance(a, torch.Tensor)
            and a.is_floating_point() and i == 0 else a
            for i, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    with torch.no_grad():
        fn(*args)


def test_fusion_model_refuses_to_train_as_jax_does(jax_model):
    """A port model with the BiFPN fusion kernels raises when a train step
    asks for gradients, where the JAX package's ``jax.grad`` through the
    Pallas fusion node (interpret mode) raises too."""
    _, variables = jax_model
    model = _port_model(variables, CFG, use_fusion_kernels=True)
    with pytest.raises(RuntimeError, match="fuse_topdown: the kernel has no"):
        make_train_step(model, CFG)(create_train_state(model),
                                    to_device(_batch(), "cpu"), SEED)

    rng = np.random.RandomState(0)
    big = jnp.asarray(rng.rand(1, 8, 8, 16), jnp.float32)
    small = jnp.asarray(rng.rand(1, 4, 4, 16), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        fuse_topdown_pallas(big, small, 0.5, 0.5)  # the forward runs
        with pytest.raises(ValueError, match="Linearization failed"):
            jax.grad(lambda b: fuse_topdown_pallas(b, small, 0.5, 0.5).sum())(
                big)
