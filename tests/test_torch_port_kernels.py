"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode and against the JAX package's
own plain formulations. The CUDA and Triton kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficientdet_tpu.kernels.fusion import (fuse_bottomup_pallas,
                                             fuse_bottomup_xla,
                                             fuse_topdown_pallas,
                                             fuse_topdown_xla)
from efficientdet_tpu.kernels.nms_kernel import nms_select_pallas
from efficientdet_tpu.ops.nms import select_and_suppress
from efficientdet_tpu_torch.kernels import fusion
from efficientdet_tpu_torch.kernels.nms_kernel import nms_select_plain


# ------------------------------------------------------------------- NMS (A)
def nms_inputs(rng, b, k, ties=False):
    """Heavily overlapping boxes, unsorted scores with padding (0) and, with
    ``ties``, scores quantized so that many are equal; the last row is all
    padding."""
    centers = rng.rand(b, k, 2).astype(np.float32) * 80
    sizes = rng.rand(b, k, 2).astype(np.float32) * 40 + 5
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=2)
    scores = rng.rand(b, k).astype(np.float32)
    if ties:
        scores = np.round(scores * 16) / 16
    scores[rng.rand(b, k) < 0.25] = 0.0
    scores[-1] = 0.0
    return scores, boxes


@pytest.mark.parametrize("b,k,d,ties", [(3, 37, 8, True), (2, 64, 8, False),
                                        (2, 128, 40, True)])
def test_nms_plain_matches_pallas_and_scan(b, k, d, ties):
    """Exact: equal indices and bit-equal scores."""
    rng = np.random.RandomState(b * k)
    scores, boxes = nms_inputs(rng, b, k, ties)
    got_s, got_i = nms_select_plain(torch.from_numpy(scores),
                                    torch.from_numpy(boxes), 0.5, d)
    assert got_s.dtype == torch.float32 and got_i.dtype == torch.int32
    pal_s, pal_i = nms_select_pallas(jnp.asarray(scores), jnp.asarray(boxes),
                                     0.5, d, interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pal_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(pal_s))
    classes = np.arange(k, dtype=np.int32)[None].repeat(b, 0)
    ref = jax.vmap(lambda s, bx, c: select_and_suppress(bx, s, c, 0.5, d))(
        jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(classes))
    valid = got_s.numpy() > 0
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    np.testing.assert_array_equal(np.where(valid, got_i.numpy(), -1),
                                  np.asarray(ref.classes))
    np.testing.assert_array_equal(np.where(valid, got_s.numpy(), -1),
                                  np.asarray(ref.scores))
    assert not valid[-1].any()  # the all-padding row


# -------------------------------------------------------- BiFPN fusion (B, C)
def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).to(
        dtype)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 16, 12, 24)])
def test_fuse_topdown_plain_matches_jax(shape):
    """rtol 1e-6: the same float32 operations in the same order."""
    rng = np.random.RandomState(0)
    b, h2, w2, c = shape
    big = rng.randn(b, h2, w2, c).astype(np.float32)
    small = rng.randn(b, h2 // 2, w2 // 2, c).astype(np.float32)
    w = np.array([0.4, 0.6], np.float32)
    got = fusion.fuse_topdown(_nchw(big), _nchw(small), torch.from_numpy(w))
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()
    args = (jnp.asarray(big), jnp.asarray(small), jnp.float32(w[0]),
            jnp.float32(w[1]))
    for want in (fuse_topdown_pallas(*args, interpret=True),
                 fuse_topdown_xla(*args)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 4, 4, 16), (1, 8, 6, 24)])
def test_fuse_bottomup_plain_matches_jax(shape):
    """rtol 1e-6: the same float32 operations in the same order."""
    rng = np.random.RandomState(1)
    b, h, w, c = shape
    cur = rng.randn(b, h, w, c).astype(np.float32)
    lower = rng.randn(b, 2 * h, 2 * w, c).astype(np.float32)
    skip = rng.randn(b, h, w, c).astype(np.float32)
    wts = np.array([0.2, 0.3, 0.5], np.float32)
    got = fusion.fuse_bottomup(_nchw(cur), _nchw(lower), _nchw(skip),
                               torch.from_numpy(wts))
    got = got.permute(0, 2, 3, 1).numpy()
    args = (jnp.asarray(cur), jnp.asarray(lower), jnp.asarray(skip),
            *map(jnp.float32, wts))
    for want in (fuse_bottomup_pallas(*args, interpret=True),
                 fuse_bottomup_xla(*args)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_fuse_plain_casts_back_to_input_dtype():
    """The math is float32; the result has the maps' dtype (bf16 here)."""
    rng = np.random.RandomState(2)
    big = _nchw(rng.randn(1, 4, 4, 8).astype(np.float32), torch.bfloat16)
    small = _nchw(rng.randn(1, 2, 2, 8).astype(np.float32), torch.bfloat16)
    w = torch.tensor([0.3, 0.7])
    got = fusion.fuse_topdown(big, small, w)
    assert got.dtype == torch.bfloat16
    up = small.float().repeat_interleave(2, 2).repeat_interleave(2, 3)
    want = ((0.3 * big.float() + 0.7 * up) / (1.0 + 1e-4)).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2)
