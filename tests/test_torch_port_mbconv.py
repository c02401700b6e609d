"""The port's fused MBConv path against the JAX package, on the CPU.

On the CPU each wrapper of ``efficientdet_tpu_torch/kernels/mbconv_kernel.py``
runs its plain PyTorch version; those are held against the JAX package's
Pallas kernels in interpret mode. ``fused_backbone_forward`` and
``make_eval_step(fused_backbone=True)`` are held against their JAX
counterparts on the small detector of ``test_torch_port_slice.py``. The CUDA
kernel itself is held against the plain versions on the card by
``chip_smoke.py``. JAX runs at ``highest`` matmul precision and torch
without TF32, so float32 agrees to the stated tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientdet_tpu.kernels import mbconv_kernel as jax_mbconv
from efficientdet_tpu.models import fused_serving as jax_fused
from efficientdet_tpu.train import make_eval_step as jax_make_eval_step
from efficientdet_tpu_torch import fused_backbone_forward, make_eval_step
from efficientdet_tpu_torch.kernels import mbconv_kernel as mk
from efficientdet_tpu_torch.models.layers import BatchNorm
from test_torch_port_slice import (CFG, SIZE, _nhwc, _port,  # noqa: F401
                                   jax_model)

# The five shapes of tests/test_kernels.py's Pallas MBConv test: (H, W,
# Cin, Ce, K, stride), block-1..4 shape classes and a non-power-of-2 map.
SHAPES = [(32, 32, 16, 96, 3, 2), (32, 32, 24, 144, 3, 1),
          (16, 16, 24, 144, 5, 2), (16, 16, 40, 240, 5, 1),
          (24, 24, 16, 96, 3, 1)]
PAIRS = {"v1": (jax_mbconv.fused_expand_dw, mk.fused_expand_dw_plain,
                mk.fused_expand_dw),
         "flat": (jax_mbconv.fused_expand_dw_flat,
                  mk.fused_expand_dw_flat_plain, mk.fused_expand_dw_flat)}


@pytest.fixture(scope="module", autouse=True)
def _precision():
    jax.config.update("jax_default_matmul_precision", "highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    jax.config.update("jax_default_matmul_precision", None)


def _inputs(h, w, cin, ce, k, seed=0, b=2):
    """The arrays of tests/test_kernels.py's MBConv test (same seed and
    scales): x (b, h, w, cin) and the weights, float32 numpy."""
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, w, cin).astype(np.float32),
            rng.randn(cin, ce).astype(np.float32) * 0.1,
            rng.rand(ce).astype(np.float32) + 0.5,
            rng.randn(ce).astype(np.float32) * 0.1,
            rng.randn(k, k, ce).astype(np.float32) * 0.1,
            rng.rand(ce).astype(np.float32) + 0.5,
            rng.randn(ce).astype(np.float32) * 0.1]


def test_fold_bn_affine_matches_jax():
    rng = np.random.RandomState(2)
    gamma, beta, mean = (rng.randn(32).astype(np.float32) for _ in range(3))
    var = rng.rand(32).astype(np.float32) + 0.1
    want = jax_mbconv.fold_bn_affine(*map(jnp.asarray, (gamma, beta, mean,
                                                        var)), 1e-3)
    got = mk.fold_bn_affine(*map(torch.from_numpy, (gamma, beta, mean, var)),
                            1e-3)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_fold_bn_affines_equals_fold_bn_affine(jax_model):
    """The multi-tensor fold of the fused backbone gives, bit for bit, what
    ``fold_bn_affine`` gives layer by layer."""
    port = _port(jax_model[1])
    bns = [m for m in port.backbone.modules() if isinstance(m, BatchNorm)]
    folded = mk.fold_bn_affines(bns)
    assert len(folded) == len(bns) == 1 + 16 * 3 - 1  # stem, 3 per block
    for bn in bns:
        want = mk.fold_bn_affine(bn.weight, bn.bias, bn.running_mean,
                                 bn.running_var, bn.eps)
        for got, w in zip(folded[bn], want):
            assert torch.equal(got, w)


@pytest.mark.parametrize("impl", ["v1", "flat"])
@pytest.mark.parametrize("h,w,cin,ce,k,s", SHAPES)
def test_plain_matches_pallas_f32(h, w, cin, ce, k, s, impl):
    """float32 within 2e-5, the tolerance of the JAX package's own test."""
    jax_fn, plain, _ = PAIRS[impl]
    args = _inputs(h, w, cin, ce, k)
    z, se = plain(*map(torch.from_numpy, args), stride=s)
    zr, ser = jax_fn(*map(jnp.asarray, args), stride=s, interpret=True)
    assert z.dtype == torch.float32 and se.dtype == torch.float32
    assert z.shape == (2, -(-h // s), -(-w // s), ce) and se.shape == (2, ce)
    np.testing.assert_allclose(z.numpy(), np.asarray(zr), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(se.numpy(), np.asarray(ser), rtol=2e-5,
                               atol=2e-5)


def _bf16_ulp(x):
    _, exp = np.frexp(np.abs(x))
    return np.ldexp(1.0, exp - 8)


@pytest.mark.parametrize("h,w,cin,ce,k,s", SHAPES[:3])
def test_flat_plain_matches_pallas_bf16(h, w, cin, ce, k, s):
    """bf16, as the serving path runs it. Both round y = swish(x @ W' + b)
    to bf16 before the depthwise; where their f32 sums round to the two bf16
    neighbours of y, z moves by at most |s1 * w_dw| * 2^-7 * |y| times
    swish's slope (< 1.1). So z is within 2 bf16 ulp plus two such flips,
    and se_mean (an f32 mean of f32 z) within 1e-3 relative."""
    args = _inputs(h, w, cin, ce, k, seed=1)
    x = torch.from_numpy(args[0]).bfloat16()
    z, se = mk.fused_expand_dw_flat_plain(
        x, *map(torch.from_numpy, args[1:]), stride=s)
    assert z.dtype == torch.bfloat16
    zr, ser = jax_mbconv.fused_expand_dw_flat(
        jnp.asarray(args[0], jnp.bfloat16), *map(jnp.asarray, args[1:]),
        stride=s, interpret=True)
    z, zr = z.float().numpy(), np.asarray(zr, np.float32)
    y_max = np.abs(x.float().numpy() @ args[1] * args[2] + args[3]).max()
    flip = 1.1 * np.abs(args[5] * args[4]).max() * 2.0 ** -7 * y_max
    assert np.all(np.abs(z - zr) <= 2 * _bf16_ulp(zr) + 2 * flip)
    np.testing.assert_allclose(se.numpy(), np.asarray(ser), rtol=1e-3,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["v1", "flat"])
def test_wrapper_on_cpu_is_plain_and_not_counted(impl):
    _, plain, wrapper = PAIRS[impl]
    args = [torch.from_numpy(a) for a in _inputs(12, 10, 16, 96, 5)]
    before = wrapper.launches
    got = wrapper(*args, stride=2)
    want = plain(*args, stride=2)
    assert wrapper.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("impl", ["v1", "flat"])
def test_wrapper_rejects_other_devices(impl):
    args = [torch.from_numpy(a).to("meta") for a in _inputs(8, 8, 16, 96, 3)]
    with pytest.raises(ValueError, match="unsupported device"):
        PAIRS[impl][2](*args, stride=1)


def test_fused_backbone_matches_jax(jax_model):
    """All 7 stages at 128 px, B=1, float32, within 2e-4 (the tolerance of
    tests/test_kernels.py's fused-backbone test); the stages come out in
    channels_last memory."""
    _, variables = jax_model
    port = _port(variables)
    x = np.random.RandomState(0).rand(1, SIZE, SIZE, 3).astype(np.float32)
    want = jax_fused.fused_backbone_forward(
        variables, jnp.asarray(x), CFG.backbone_name, dtype=jnp.float32,
        interpret=True)
    with torch.no_grad():
        got = fused_backbone_forward(port.backbone, torch.from_numpy(x),
                                     torch.float32)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=2e-4,
                                   atol=2e-4, err_msg=f"stage {i}")


def test_fused_backbone_rejects_odd_sizes(jax_model):
    port = _port(jax_model[1])
    with pytest.raises(ValueError, match="even input sizes"):
        fused_backbone_forward(port.backbone, torch.zeros(1, 130, 129, 3),
                               torch.float32)


def test_fused_eval_step_matches_jax(jax_model):
    """uint8 images through both fused-backbone eval steps: valid and
    classes equal, scores within 1e-5, boxes within 1e-3 px, as the unfused
    slice test holds them."""
    model, variables = jax_model
    images = np.random.RandomState(5).randint(
        0, 256, size=(2, SIZE, SIZE, 3)).astype(np.uint8)
    want = jax.jit(jax_make_eval_step(model, CFG, fused_backbone=True))(
        variables, jnp.asarray(images))
    got = make_eval_step(_port(variables), CFG, fused_backbone=True)(
        torch.from_numpy(images))
    assert int(got.valid.sum()) > 20  # the NMS did real work
    for name in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-3)
