"""Greedy select-and-suppress NMS: the CUDA kernel and its plain version.

Counterpart of ``efficientdet_tpu/kernels/nms_kernel.py::nms_select_pallas``.
The kernel is ``csrc/nms_select.cu``: one block per image sorts the
candidates by (score descending, index ascending), then walks them in
windows of 512 sorted positions, building each window's IoU bit-mask in
shared memory a word at a time ahead of a one-warp scan (its header says
what bounds it on the H100). ``nms_select_plain`` is the same function in
plain PyTorch: the CPU path and the reference that the kernel is held
against on the card.

Each of the D steps takes the first-index maximum of the remaining scores,
emits it only if it is > 0, and then zeroes it and every candidate whose IoU
with it exceeds the threshold. The IoU denominator is clamped at 1e-8.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, card_kernel

# The order phase sorts K 64-bit keys, padded to a power of two, in shared
# memory beside the sorted scores and indices: 128 KB at K = 8192.
MAX_CANDIDATES = 8192


def phase_cycles(cycles: torch.Tensor) -> torch.Tensor:
    """(B, 6) int64 from the counters ``_launch`` filled: each image's SM
    cycles in the order phase, in loading the windows (with the OR of the
    bits of the rows kept in earlier windows), in the windows' masks and
    scans (which overlap) and in the whole kernel; the number of windows
    walked; and the scan's cycles spent waiting for the mask warps."""
    return cycles[:, :6]


def nms_select_plain(scores: torch.Tensor, boxes: torch.Tensor,
                     iou_threshold: float, max_detections: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (B, K) f32, boxes (B, K, 4) f32) -> (scores (B, D) f32, 0
    where invalid; idx (B, D) int32, 0 where invalid)."""
    k = scores.shape[1]
    remaining = scores.clamp_min(0.0)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    iota = torch.arange(k, device=scores.device)
    out_s, out_i = [], []
    for _ in range(max_detections):
        best = remaining.amax(dim=1, keepdim=True)
        valid = best > 0.0
        idx = torch.where(remaining == best, iota, k).amin(dim=1, keepdim=True)
        bx1, by1, bx2, by2 = (c.gather(1, idx) for c in (x1, y1, x2, y2))
        iw = torch.minimum(bx2, x2) - torch.maximum(bx1, x1)
        ih = torch.minimum(by2, y2) - torch.maximum(by1, y1)
        inter = iw.clamp_min(0.0) * ih.clamp_min(0.0)
        b_area = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
        iou = inter / (area + b_area - inter).clamp_min(1e-8)
        suppress = (iou > iou_threshold) | (iota == idx)
        remaining = remaining.masked_fill(valid & suppress, 0.0)
        out_s.append(torch.where(valid, best, 0.0))
        out_i.append(torch.where(valid, idx, 0))
    return torch.cat(out_s, dim=1), torch.cat(out_i, dim=1).to(torch.int32)


@card_kernel(nms_select_plain)
def nms_select(scores: torch.Tensor, boxes: torch.Tensor,
               iou_threshold: float, max_detections: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS per image; same contract as ``nms_select_plain``, bit for
    bit, for unsorted scores too.

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    on the current stream, with its (B, 8) int64 cycle counters from
    ``torch.empty``, or raises on what the kernel does not take; other
    devices raise, and so does any device on inputs that need a gradient
    (``card_kernel``). ``nms_select.launches`` counts kernel launches."""
    if scores.dtype != torch.float32 or boxes.dtype != torch.float32:
        raise TypeError(f"nms_select: need float32, got {scores.dtype}, "
                        f"{boxes.dtype}")
    if scores.dim() != 2 or tuple(boxes.shape) != (*scores.shape, 4):
        raise ValueError(f"nms_select: shapes {tuple(scores.shape)}, "
                         f"{tuple(boxes.shape)}; need (B, K), (B, K, 4)")
    if boxes.device != scores.device:
        raise ValueError("nms_select: scores and boxes on different devices")
    if not (scores.is_contiguous() and boxes.is_contiguous()):
        raise ValueError("nms_select: inputs must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_select: boxes must be 16-byte aligned (float4)")
    b, k = scores.shape
    if not 0 < k <= MAX_CANDIDATES or max_detections < 1:
        raise ValueError(f"nms_select: K={k} (1..{MAX_CANDIDATES}), "
                         f"D={max_detections} (>= 1)")
    cycles = torch.empty((b, 8), dtype=torch.int64, device=scores.device)
    return _launch(scores, boxes, iou_threshold, max_detections, cycles)


def _launch(scores, boxes, iou_threshold, max_detections, cycles):
    """Launches the kernel on checked inputs; ``cycles`` (B, 8) int64
    receives its counters (``phase_cycles``). Raises when the launch
    fails."""
    b, k = scores.shape
    out_s = torch.empty((b, max_detections), dtype=torch.float32,
                        device=scores.device)
    out_i = torch.empty((b, max_detections), dtype=torch.int32,
                        device=scores.device)
    _build.call("edt_nms_select", scores.device, scores.data_ptr(),
                boxes.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                cycles.data_ptr(), b, k, max_detections,
                float(iou_threshold))
    return out_s, out_i
