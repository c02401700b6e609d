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
import torch.nn.functional as F

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


# ------------------------------------------------------------ the kernel's host side
def _kernel_shapes():
    """(Cin, Ce, K, stride, H) of D0@512's 11 distinct blocks and of
    efficientnet-b6's widest expansion at 1408 px (what chip_smoke.py
    drives on the card)."""
    import chip_smoke
    return list(chip_smoke.d0_mbconv_shapes()) + [chip_smoke.b6_widest_shape()]


KERNEL_SHAPES = _kernel_shapes()


def test_kernel_shapes_are_d0_and_b6():
    assert len(KERNEL_SHAPES) == 12
    assert KERNEL_SHAPES[0] == (16, 96, 3, 2, 256)
    assert KERNEL_SHAPES[-1] == (576, 3456, 3, 1, 11)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_tile_plan_fits_shared_memory(shape, dtype):
    """At most the 232,448 bytes a block may use; the bf16 plan leaves room
    for two blocks per SM (228 KB, 1 KB reserved per block)."""
    plan = mk.tile_plan(*shape, dtype)
    assert plan.smem_bytes <= 232448
    if dtype == torch.bfloat16:
        assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
        assert plan.row_stride >= plan.patch_w * 2 * plan.channel_tile
        assert (plan.stride * plan.row_stride) % 128 == 32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_tile_plan_covers_output_once(shape, dtype):
    """The spatial tiles, clipped at the map's edge, cover every output
    exactly once, and each tile's patch holds its depthwise windows."""
    cin, ce, k, stride, h = shape
    plan = mk.tile_plan(*shape, dtype)
    out = -(-h // stride)
    assert (plan.out_h, plan.out_w) == (out, out)
    tiles_h, tiles_w = plan.tiles
    cover = np.zeros((out, out), np.int32)
    for tile in range(tiles_h * tiles_w):  # as the kernel places its tiles
        r = (tile // tiles_w) * plan.tile_h
        c = (tile % tiles_w) * plan.tile_w
        cover[r:r + plan.tile_h, c:c + plan.tile_w] += 1
    assert (cover == 1).all()
    assert plan.patch_h == (plan.tile_h - 1) * stride + k
    assert plan.patch_w == (plan.tile_w - 1) * stride + k
    assert ce % plan.channel_tile == 0


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_tile_plan_fills_the_card_at_batch_32(shape):
    """At least two blocks for each of the H100's 132 SMs at B=32."""
    blocks, batch = mk.tile_plan(*shape, torch.bfloat16).grid(32)
    assert blocks * batch >= 2 * 132


@pytest.mark.parametrize("cin", [16, 24, 40, 80, 112, 192, 576])
def test_packed_weights_unpack_to_w(cin):
    """(Cin, Ce) -> (Ce, Cin_pad) bf16: unpacked it is W in bf16, and the
    lanes from Cin to Cin_pad (a multiple of 16) are 0."""
    ce = 6 * cin
    w = torch.randn(cin, ce, generator=torch.Generator().manual_seed(cin))
    packed = mk.pack_expand_weights(w)
    cin_pad = -(-cin // 16) * 16
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert tuple(packed.shape) == (ce, cin_pad)
    assert cin_pad == mk.tile_plan(cin, ce, 3, 1, 16, torch.bfloat16).cin_pad
    assert torch.equal(packed[:, :cin].t(), w.to(torch.bfloat16))
    assert not packed[:, cin:].any()
    # With the flat contract's BN0 scale folded in: bf16(W * s0), as
    # _prepare_flat rounds it.
    s0 = torch.rand(ce, generator=torch.Generator().manual_seed(1)) + 0.5
    folded = mk.pack_expand_weights(w, s0)
    want, _, _ = mk._prepare_flat(torch.zeros(1, dtype=torch.bfloat16), w,
                                  s0, s0)
    assert torch.equal(folded[:, :cin].t(), want)
    assert not folded[:, cin:].any()


@pytest.mark.parametrize("shape,want_ms,by", [
    # x 32*256*256*16 + z 32*128*128*96 + W 16*96 bf16 = 167,775,232 bytes,
    # w_dw 9*96 + four vectors 4*96 + se 32*96 f32 = 17,280 bytes:
    # 167,792,512 / 3.35e12 s; 7.35 GFLOP would take 0.0074 ms.
    ((16, 96, 3, 2, 256), 167792512 / 3.35e9, "bytes"),
    # x 32*8*8*192 + z 32*8*8*1152 + W 192*1152 bf16 = 5,947,392 bytes,
    # (25 + 4 + 32) * 1152 f32 = 281,088 bytes: 6,228,480 / 3.35e12 s;
    # 1.02 GFLOP would take 0.0010 ms.
    ((192, 1152, 5, 1, 8), 6228480 / 3.35e9, "bytes"),
])
def test_bound_arithmetic(shape, want_ms, by):
    import chip_smoke
    ms, got_by = chip_smoke.mbconv_bound(shape, 32)
    assert got_by == by
    assert ms == pytest.approx(want_ms, rel=1e-12)


# ------------------------------------------------------------ rounding model
ORDER_SLACK = 6.0 * 2.0 ** -24   # csrc/mbconv_fused.cu, tc::kOrderSlack / 1.1


def _order_model(cin, n_px=2048, ce=48, seed=0):
    """y = bf16(swish(acc + b)) with acc summed two ways over bf16 x and W:
    in k order with a fused multiply-add per term, as the plain version's
    f32 GEMM sums, and as the bf16 kernel sums, 16-term partials from the
    tensor cores (exact, then truncated once to f32) added in k order.
    Returns (|difference| / (u ||x|| ||w||), y bits both ways, the
    kernel's flags)."""
    rng = np.random.RandomState(seed)
    bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16() \
        .float().numpy()
    x = bf16(rng.randn(n_px, cin))
    w = bf16(rng.randn(cin, ce) / np.sqrt(cin) * (rng.rand(ce) + 0.5))
    b = bf16(rng.randn(ce) * 0.5)
    seq = np.zeros((n_px, ce), np.float32)
    for k in range(cin):  # x * w is exact in f32: one rounding, as fmaf
        seq = (seq + x[:, k:k + 1] * w[k]).astype(np.float32)
    tc = np.zeros((n_px, ce), np.float32)
    for k in range(0, cin, 16):
        part = x[:, k:k + 16].astype(np.float64) @ w[k:k + 16]
        trunc = part.astype(np.float32)
        over = np.abs(trunc.astype(np.float64)) > np.abs(part)
        trunc[over] = np.nextafter(trunc[over], np.float32(0))
        tc = (tc + trunc).astype(np.float32)
    norm = np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(w, axis=0)
    ratio = np.abs(seq.astype(np.float64) - tc) / (2.0 ** -24 * norm)

    def y_bits(acc):
        v = torch.from_numpy(acc + b)
        return F.silu(v).bfloat16().view(torch.int16).numpy(), v

    want, _ = y_bits(seq)
    got, v = y_bits(tc)
    y = F.silu(v)
    # The kernel's rule, swish_unsure: y within its two errors' bound of a
    # bf16 rounding boundary (here with the exact swish, so the order's).
    dy = 1.1 * ORDER_SLACK * torch.from_numpy(norm.astype(np.float32))
    lo, hi = (y - dy).bfloat16(), (y + dy).bfloat16()
    return ratio, want, got, (lo != hi).numpy()


@pytest.mark.parametrize("cin", [16, 24, 40, 80, 112, 192])
def test_rounding_fixups_catch_every_order_flip(cin):
    """The two orders' difference stays well inside the kernel's slack, and
    every y whose bf16 rounding the order changes is one the kernel flags
    for the sequential recompute; the flags are a small share."""
    ratio, want, got, flagged = _order_model(cin)
    assert ratio.max() * 2.0 ** -24 < ORDER_SLACK / 2
    flips = want != got
    assert not (flips & ~flagged).any()
    assert flagged.mean() < 0.03
