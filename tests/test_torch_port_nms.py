"""The NMS kernel's algorithm and the mask formulation, on the CPU.

``csrc/nms_select.cu`` cannot run here, so ``kernel_model`` below does in
numpy what it does: the packed sort keys with their -0.0
canonicalisation; then, window by window, each word's diagonal block of the
IoU bit-mask (garbage where the kernel writes none, to show it is never
read), the kept rows' bits over each later word, and the warp's word-wise
resolution in rounds with its stops at D and at P.
The IoU bits use the kernel's float32 arithmetic with its division-free
test, which ``test_division_free_test_equals_the_divide`` holds against the
divide. The model is held bit-equal to ``nms_select_plain`` and to
``nms_select_pallas(interpret=True)`` on the edge cases of
``chip_smoke.nms_edge_cases``, which the card holds the kernel itself to.
The port's ``greedy_suppression_mask`` is held against the JAX function.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efficientdet_tpu.kernels.nms_kernel import nms_select_pallas
from efficientdet_tpu.ops import nms as jax_nms
from efficientdet_tpu_torch.kernels.nms_kernel import nms_select_plain
from efficientdet_tpu_torch.ops import nms as pt_nms

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import nms_edge_cases  # noqa: E402

FULL = 0xFFFFFFFF
WINDOW = 512  # the kernel's kWindow
EDGE_CASES = tuple(nms_edge_cases())  # the names; the same in every worker
F32 = np.float32


def model_order(scores):
    """(sorted order of the P positive candidates, P), as the order phase
    sorts: keys (canonical score bits << 32 | K-1-j), descending."""
    k = scores.shape[0]
    canon = np.where(scores > 0, scores, F32(0)).astype(F32)
    bits = canon.view(np.uint32).astype(np.uint64)
    keys = (bits << np.uint64(32)) | (k - 1 - np.arange(k)).astype(np.uint64)
    order = k - 1 - (np.sort(keys)[::-1] & np.uint64(FULL)).astype(np.int64)
    npos = int((bits > 0).sum())
    if np.all(keys[:-1] > keys[1:]):  # the kernel skips the sort here
        assert np.array_equal(order[:npos], np.arange(npos))
    return order[:npos], npos


def above(inter, denom, t):
    """The kernel's ``iou_above`` decision on float32 arrays: false where
    lo = RN(inter - t denom) is finite and < 0, true where hi =
    RN(inter - t_next denom) is finite and > 0, else the divide. t denom is
    exact in float64, and the difference rounded to float64 and then to
    float32 has the exact difference's sign, as the kernel's fused
    multiply-add does; it is 0 only where the exact difference is 0 or
    below float32's range, and there both divide."""
    t = F32(t)
    t_next = np.nextafter(t, F32(np.inf))
    inter64, denom64 = inter.astype(np.float64), denom.astype(np.float64)
    with np.errstate(all="ignore"):
        lo = (inter64 - np.float64(t) * denom64).astype(F32)
        hi = (inter64 - np.float64(t_next) * denom64).astype(F32)
        divide = inter / denom > t
    return np.where((lo < 0) & np.isfinite(lo), False,
                    np.where((hi > 0) & np.isfinite(hi), True, divide))


def iou_bits(rows, cols, thr):
    """(R, C) bool: IoU(row, col) > thr with the kernel's arithmetic."""
    zero = F32(0)

    def area(b):
        return (np.maximum(b[:, 2] - b[:, 0], zero)
                * np.maximum(b[:, 3] - b[:, 1], zero))

    a, b = rows[:, None], cols[None]
    iw = np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0])
    ih = np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1])
    inter = np.maximum(iw, zero) * np.maximum(ih, zero)
    denom = np.maximum(area(cols)[None] + area(rows)[:, None] - inter,
                       F32(1e-8))
    return above(inter, denom, thr)


def pack(bits):
    """(..., 32 n) bool -> (..., n) uint32 words, bit j of word w is
    column 32 w + j."""
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(*bits.shape[:-1], -1, 32) * weights).sum(-1).astype(
        np.uint32)


def model_windows(boxes, npos, d, thr, window, rng):
    """The mask and scan phases over one image's P sorted boxes: the kept
    sorted positions, in order."""
    words = window // 32
    kept = []
    for c0 in range(0, npos, window):
        if len(kept) >= d:
            break
        nw = min(window, npos - c0)
        wbox = np.zeros((window, 4), F32)  # zero boxes past P
        wbox[:nw] = boxes[c0:c0 + nw]
        # Each word's diagonal block; garbage where the kernel writes none.
        diag = rng.randint(0, 2 ** 32, size=window, dtype=np.uint64).astype(
            np.uint32)
        for w in range(words):
            if 32 * w < nw:
                rows = wbox[32 * w:32 * w + 32]
                diag[32 * w:32 * w + 32] = pack(iou_bits(rows, rows, thr))[:, 0]
        pre = np.zeros(words, np.uint32)
        if kept:
            pre = pack(iou_bits(boxes[kept], wbox, thr).any(0))
        here = []  # this window's keeps, window positions
        for w in range(words):
            if len(kept) >= d or 32 * w >= nw:
                break
            first = 32 * w
            removed = 0 if nw - first >= 32 else (FULL << (nw - first)) & FULL
            removed |= int(pre[w])
            if here:  # acc and the previous word's keeps
                removed |= int(pack(iou_bits(
                    wbox[here], wbox[first:first + 32], thr).any(0))[0])
            # Rounds over the diagonal block, whose row i is also its column.
            rows = [int(x) for x in diag[first:first + 32]]
            open_, kw = ~removed & FULL, 0
            while open_:
                keep = drop = 0
                for i in range(32):
                    below = (1 << i) - 1
                    if open_ >> i & 1 and not rows[i] & (kw | open_) & below:
                        keep |= 1 << i
                    if open_ >> i & 1 and rows[i] & kw & below:
                        drop |= 1 << i
                kw |= keep
                open_ &= ~(keep | drop)
            while bin(kw).count("1") > d - len(kept):
                kw &= ~(1 << (kw.bit_length() - 1))
            here += [first + i for i in range(32) if kw >> i & 1]
            kept += [c0 + first + i for i in range(32) if kw >> i & 1]
    return kept


def kernel_model(scores, boxes, thr, d, window=WINDOW, seed=0):
    """The kernel per image: (scores (B, D) f32, idx (B, D) int32)."""
    b, k = scores.shape
    rng = np.random.RandomState(seed)
    out_s = np.zeros((b, d), F32)
    out_i = np.zeros((b, d), np.int32)
    for n in range(b):
        order, npos = model_order(scores[n])
        kept = model_windows(boxes[n][order], npos, d, thr, window, rng)
        out_s[n, :len(kept)] = scores[n][order[kept]]
        out_i[n, :len(kept)] = order[kept]
    return out_s, out_i


@pytest.mark.parametrize("name", EDGE_CASES)
def test_kernel_model_matches_plain_and_pallas(name):
    """Bit-equal scores and equal indices, with the kernel's window and with
    windows of 64 (many windows, the kept rows' OR in each)."""
    scores, boxes, d, thr = nms_edge_cases()[name]
    want_s, want_i = nms_select_plain(torch.from_numpy(scores),
                                      torch.from_numpy(boxes), thr, d)
    pal_s, pal_i = nms_select_pallas(jnp.asarray(scores), jnp.asarray(boxes),
                                     thr, d, interpret=True)
    np.testing.assert_array_equal(want_i.numpy(), np.asarray(pal_i))
    np.testing.assert_array_equal(want_s.numpy(), np.asarray(pal_s))
    for window in (WINDOW, 64):
        got_s, got_i = kernel_model(scores, boxes, thr, d, window)
        np.testing.assert_array_equal(got_i, want_i.numpy())
        np.testing.assert_array_equal(got_s.view(np.uint32),
                                      want_s.numpy().view(np.uint32))
    kept = (want_s > 0).sum(1)
    if name == "exactly_d_live_left":
        assert (kept == d).all() and ((scores > 0).sum(1) > d).all()
    if name == "fewer_than_d":
        assert (kept < d).all()
    if name == "past_first_window":
        assert (kept > WINDOW).all()
    if name == "all_padding_row":
        assert kept[1] == 0


def test_raw_negative_zero_bits_would_sort_first():
    """Why the order phase maps every score <= 0 to key bits 0: -0.0's own
    bits (0x80000000) exceed every positive float's as unsigned integers,
    so a key packed from them would put a padding candidate first."""
    neg_zero = np.array([-0.0], np.float32).view(np.uint32)[0]
    largest = np.array([np.finfo(np.float32).max], np.float32).view(
        np.uint32)[0]
    assert neg_zero == 0x80000000 and neg_zero > largest
    scores = np.array([-0.0, 0.5, 0.25], np.float32)
    order, npos = model_order(scores)
    assert npos == 2 and order.tolist() == [1, 2]


@pytest.mark.parametrize("t", [0.5, 0.3, 0.45, 0.7, 1e-3, 1.0, 0.0, -0.25,
                               3e-39])
def test_division_free_test_equals_the_divide(t):
    """The kernel's IoU test gives the divide's bit at threshold t: on
    random quotients, on quotients within a few ulps of t and exactly at
    it, and on zero, denormal, huge, infinite and NaN operands."""
    rng = np.random.RandomState(0)
    t = F32(t)
    denom = np.concatenate([
        (rng.rand(4000) * 1e4).astype(F32) + F32(1e-8),
        F32(2.0) ** rng.randint(-20, 20, 1000).astype(F32),
        np.array([1e-8, 1.0, 3e38, np.inf], F32)]).astype(F32)
    with np.errstate(all="ignore"):
        near = (t * denom).astype(F32)
    inter = [near, (rng.rand(denom.size) * denom).astype(F32),
             np.zeros_like(denom), np.full_like(denom, 1e-45),
             np.full_like(denom, np.inf), np.full_like(denom, np.nan)]
    up = down = near
    for _ in range(3):  # 1, 2 and 3 ulps either side of t * denom
        with np.errstate(all="ignore"):
            up = np.nextafter(up, F32(np.inf))
            down = np.nextafter(down, F32(-np.inf))
        inter += [up, down]
    for i in inter:
        i = i if np.isnan(i).all() else np.maximum(i, F32(0))
        with np.errstate(all="ignore"):
            want = i / denom > t
        np.testing.assert_array_equal(above(i, denom, t), want)


def sorted_candidates(rng, k, ties, padding):
    """Score-sorted well-formed boxes (x2 >= x1, y2 >= y1), padding last."""
    centers = rng.rand(k, 2).astype(np.float32) * 60
    sizes = rng.rand(k, 2).astype(np.float32) * 30 + 4
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1)
    scores = rng.rand(k).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8
    scores[rng.rand(k) < padding] = 0.0
    order = np.argsort(-scores, kind="stable")
    return boxes[order], scores[order].astype(np.float32)


@pytest.mark.parametrize("k,ties,padding,inverted", [
    (40, True, 0.2, False), (64, False, 0.3, False), (25, True, 0.0, False),
    (30, False, 0.1, True)])
def test_greedy_suppression_mask_matches_jax(k, ties, padding, inverted):
    """Equal keep-masks, inverted boxes (x2 < x1, unclamped areas) included;
    and for well-formed boxes the kept positions are the ones the select
    formulation emits, in order."""
    rng = np.random.RandomState(k)
    boxes, scores = sorted_candidates(rng, k, ties, padding)
    if inverted:
        boxes[::3] = boxes[::3][:, [2, 3, 0, 1]]
    got = pt_nms.greedy_suppression_mask(torch.from_numpy(boxes),
                                         torch.from_numpy(scores), 0.5)
    want = jax_nms.greedy_suppression_mask(jnp.asarray(boxes),
                                           jnp.asarray(scores), 0.5)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if inverted:
        return
    out_s, out_i = nms_select_plain(torch.from_numpy(scores)[None],
                                    torch.from_numpy(boxes)[None], 0.5, k)
    np.testing.assert_array_equal(
        out_i[0][out_s[0] > 0].numpy(), np.flatnonzero(got.numpy()))
