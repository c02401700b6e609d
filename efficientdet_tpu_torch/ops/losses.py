"""Focal classification loss and smooth-L1 box regression with anchor
matching.

Counterpart of ``efficientdet_tpu/ops/losses.py``, batched over images
where the JAX package ``vmap``s one image:

- annotations are (B, M, 5) [x1, y1, x2, y2, label], padded with -1 rows;
- anchors are matched to the valid GT of their image by IoU: >= 0.5
  positive (the argmax GT's label, first index on ties), < 0.4 negative,
  in between ignored; the match is gather-free, one-hot sums over M as in
  the JAX package;
- focal BCE (alpha 0.25, gamma 2) summed over the attended anchors, and
  smooth-L1 (beta 1/9) over the positives' four deltas, each normalized per
  image by its positive count; an image without GT contributes 0; the
  losses are batch means.

The training path is ``focal_loss_from_level_logits`` on per-level logits
in the compute dtype. Its focal sum is ``_FocalClsSum``, an autograd
Function with the JAX package's analytic backward: the forward keeps only
the logits and the (B, A) match vectors, and the backward rebuilds the
elementwise chain once. ``focal_loss`` (probabilities, clipped) is the
reference form.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from .boxes import encode_boxes, pairwise_iou

Pair = Tuple[torch.Tensor, torch.Tensor]


class Match(NamedTuple):
    """Per-anchor assignment of a batch: (B, A) vectors and (B,) counts."""
    assigned_label: torch.Tensor  # (B, A) int32, clipped to [0, C-1]
    positive: torch.Tensor        # (B, A) bool, IoU >= 0.5
    attend: torch.Tensor          # (B, A) bool, positive or IoU < 0.4
    num_positive: torch.Tensor    # (B,) int64
    matched_gt: torch.Tensor      # (B, A, 4) box of the argmax GT
    has_gt: torch.Tensor          # (B,) bool, any valid GT


@torch.no_grad()
def _match_anchors(anchors: torch.Tensor, annotations: torch.Tensor,
                   num_classes: int) -> Match:
    """anchors (A, 4), annotations (B, M, 5) -1 padded -> ``Match``."""
    gt_boxes = annotations[..., :4]
    gt_labels = annotations[..., 4]
    valid = gt_labels != -1                                      # (B, M)
    # Invalid GT columns sit below any real IoU, so the argmax takes them
    # only when an image has no valid GT.
    iou = torch.where(valid[:, None, :], pairwise_iou(anchors, gt_boxes),
                      -1.0)                                      # (B, A, M)
    iou_max, iou_argmax = iou.max(dim=2)                         # first max
    assign = iou_argmax[..., None] == torch.arange(
        gt_boxes.shape[1], device=anchors.device)                # (B, A, M)
    positive = iou_max >= 0.5
    label = torch.where(assign, gt_labels[:, None, :], 0.0).sum(dim=2)
    matched_gt = torch.stack(
        [torch.where(assign, gt_boxes[:, None, :, k], 0.0).sum(dim=2)
         for k in range(4)], dim=-1)
    return Match(label.clamp(0, num_classes - 1).to(torch.int32), positive,
                 positive | (iou_max < 0.4), positive.sum(dim=1), matched_gt,
                 valid.any(dim=1))


def _is_pos_class(assigned_label: torch.Tensor, positive: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """(B, A, C) bool one-hot of the assigned class on positive anchors."""
    classes = torch.arange(num_classes, dtype=assigned_label.dtype,
                           device=assigned_label.device)
    return positive[..., None] & (assigned_label[..., None] == classes)


def _smooth_l1_elem(diff: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 of a signed difference, beta = 1/9."""
    beta = 1.0 / 9.0
    d = diff.abs()
    return torch.where(d <= beta, 0.5 * 9.0 * d ** 2, d - 0.5 * beta)


def _smooth_l1(reg_preds: torch.Tensor, reg_targets: torch.Tensor,
               positive: torch.Tensor, num_positive: torch.Tensor
               ) -> torch.Tensor:
    """(B,) mean smooth-L1 over each image's positive deltas."""
    smooth_l1 = _smooth_l1_elem(reg_targets - reg_preds)
    pos_f = positive.to(smooth_l1.dtype)[..., None]
    return (smooth_l1 * pos_f).sum(dim=(1, 2)) / (
        4.0 * num_positive.to(smooth_l1.dtype)).clamp_min(1.0)


def _focal_terms(logits: torch.Tensor, assigned_label: torch.Tensor,
                 positive: torch.Tensor, alpha: float, gamma: float):
    """The elementwise chain of the logits-form focal BCE, in float32:
    (t, s = 1 - p_t, s^gamma, sp = softplus(-z) = -log p_t, alpha_t), with
    z = t ? x : -x. Negation is exact, so it runs in the logits' dtype
    before the one float32 copy."""
    t = _is_pos_class(assigned_label, positive, logits.shape[-1])
    neg_z = torch.where(t, -logits, logits).float()
    s = torch.sigmoid(neg_z)
    if gamma == 2.0:
        focal = s * s
    elif gamma == 1.0:
        focal = s
    else:
        focal = s ** gamma
    sp = F.softplus(neg_z)
    del neg_z
    return t, s, focal, sp, torch.where(t, alpha, 1.0 - alpha)


class _FocalClsSum(torch.autograd.Function):
    """Per-image unnormalized focal-BCE sums (B,) of (B, A, C) logits, with
    the analytic gradient

        d elem / d z = -alpha_t * s^gamma * (gamma * (1 - s) * sp + s),

    dz/dx = +-1, masked by ``attend`` and scaled by each image's upstream
    gradient (a (B,) tensor, as JAX's ``vmap`` hands each image its own).
    The gradient is returned in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, assigned_label, positive, attend, alpha, gamma):
        _, _, focal, sp, alpha_t = _focal_terms(logits, assigned_label,
                                                positive, alpha, gamma)
        elem = alpha_t.mul_(focal).mul_(sp)
        ctx.save_for_backward(logits, assigned_label, positive, attend)
        ctx.alpha, ctx.gamma = alpha, gamma
        return elem.masked_fill_(~attend[..., None], 0.0).sum(dim=(1, 2))

    @staticmethod
    def backward(ctx, grad):
        logits, assigned_label, positive, attend = ctx.saved_tensors
        gamma = ctx.gamma
        t, s, focal, sp, alpha_t = _focal_terms(logits, assigned_label,
                                                positive, ctx.alpha, gamma)
        inner = torch.rsub(s, 1.0).mul_(gamma).mul_(sp).add_(s)
        del sp
        d = alpha_t.neg_().mul_(focal).mul_(inner)
        del inner, focal, s
        dx = torch.where(t, d, d.neg())
        dx.masked_fill_(~attend[..., None], 0.0).mul_(grad[:, None, None])
        return dx.to(logits.dtype), None, None, None, None, None


def _focal_cls_sum_plain(logits: torch.Tensor, assigned_label: torch.Tensor,
                         positive: torch.Tensor, attend: torch.Tensor,
                         alpha: float, gamma: float) -> torch.Tensor:
    """``_FocalClsSum`` in plain autograd ops: the reference its analytic
    backward is held against."""
    _, _, focal, sp, alpha_t = _focal_terms(logits, assigned_label, positive,
                                            alpha, gamma)
    return torch.where(attend[..., None], alpha_t * focal * sp, 0.0).sum(
        dim=(1, 2))


def _logit_sums(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
                anchors: torch.Tensor, annotations: torch.Tensor,
                alpha: float, gamma: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalized per-image (cls_sum, reg_sum, num_positive), each (B,),
    over one set of anchors. The loss decomposes exactly over any partition
    of the anchors (the match is per anchor, the normalization per image),
    so the training path sums these per level and normalizes once."""
    m = _match_anchors(anchors, annotations, cls_logits.shape[-1])
    cls_sum = _FocalClsSum.apply(cls_logits, m.assigned_label, m.positive,
                                 m.attend, alpha, gamma)
    smooth_l1 = _smooth_l1_elem(encode_boxes(anchors, m.matched_gt)
                                - reg_preds.float())
    reg_sum = (smooth_l1 * m.positive.float()[..., None]).sum(dim=(1, 2))
    return cls_sum, reg_sum, m.num_positive


def focal_loss(cls_probs: torch.Tensor, reg_preds: torch.Tensor,
               anchors: torch.Tensor, annotations: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> Pair:
    """Probability form: cls_probs (B, A, C) sigmoid outputs, reg_preds
    (B, A, 4), anchors (A, 4), annotations (B, M, 5) -> (cls_loss,
    reg_loss) batch means. Plain autograd; probabilities clipped to
    [1e-4, 1 - 1e-4]."""
    m = _match_anchors(anchors, annotations, cls_probs.shape[-1])
    is_pos = _is_pos_class(m.assigned_label, m.positive, cls_probs.shape[-1])
    p = cls_probs.clamp(1e-4, 1.0 - 1e-4)
    pt = torch.where(is_pos, p, 1.0 - p)
    alpha_factor = torch.where(is_pos, alpha, 1.0 - alpha)
    one_minus_pt = 1.0 - pt
    if gamma == 2.0:
        focal = one_minus_pt * one_minus_pt
    elif gamma == 1.0:
        focal = one_minus_pt
    else:
        focal = one_minus_pt ** gamma
    cls_elem = alpha_factor * focal * -torch.log(pt)
    cls_loss = torch.where(m.attend[..., None], cls_elem, 0.0).sum(
        dim=(1, 2)) / m.num_positive.to(p.dtype).clamp_min(1.0)
    reg_loss = _smooth_l1(reg_preds, encode_boxes(anchors, m.matched_gt),
                          m.positive, m.num_positive)
    has_gt = m.has_gt.to(cls_loss.dtype)
    return (cls_loss * has_gt).mean(), (reg_loss * has_gt).mean()


def focal_loss_from_logits(cls_logits: torch.Tensor, reg_preds: torch.Tensor,
                           anchors: torch.Tensor, annotations: torch.Tensor,
                           alpha: float = 0.25, gamma: float = 2.0) -> Pair:
    """Logits form on concatenated (B, A, C) logits, any float dtype: the
    same numbers as ``focal_loss_from_level_logits`` with one level."""
    return focal_loss_from_level_logits([cls_logits], [reg_preds], [anchors],
                                        annotations, alpha, gamma)


def focal_loss_from_level_logits(cls_levels: Sequence[torch.Tensor],
                                 reg_levels: Sequence[torch.Tensor],
                                 anchor_levels: Sequence[torch.Tensor],
                                 annotations: torch.Tensor,
                                 alpha: float = 0.25, gamma: float = 2.0
                                 ) -> Pair:
    """The training path: per-level logits [(B, A_l, C)], deltas
    [(B, A_l, 4)] and anchors [(A_l, 4)] -> (cls_loss, reg_loss), with no
    (B, A_total, C) concatenation."""
    if not len(cls_levels) == len(reg_levels) == len(anchor_levels):
        raise ValueError(
            "focal_loss_from_level_logits: per-level lists must align, got "
            f"{len(cls_levels)} cls / {len(reg_levels)} reg / "
            f"{len(anchor_levels)} anchor levels")
    cls_sums, reg_sums, pos_counts = 0.0, 0.0, 0
    for cls_l, reg_l, anchors_l in zip(cls_levels, reg_levels, anchor_levels):
        c, r, p = _logit_sums(cls_l, reg_l, anchors_l, annotations, alpha,
                              gamma)
        cls_sums = cls_sums + c
        reg_sums = reg_sums + r
        pos_counts = pos_counts + p
    pos_f = pos_counts.float()
    cls_loss = cls_sums / pos_f.clamp_min(1.0)
    reg_loss = reg_sums / (4.0 * pos_f).clamp_min(1.0)
    has_gt = (annotations[..., 4] != -1).any(dim=1).to(cls_loss.dtype)
    return (cls_loss * has_gt).mean(), (reg_loss * has_gt).mean()
