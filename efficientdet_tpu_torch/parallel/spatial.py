"""The mesh's 'spatial' axis: activation height split over ranks, with the
halo exchanges written out (ROADMAP A17).

In the JAX package, ``image_sharding`` splits image height over the mesh's
'spatial' axis, and XLA's SPMD partitioner inserts the exchanges that every
strided and windowed op needs (``efficientdet_tpu/parallel/mesh.py:15-22``).
PyTorch has no such partitioner, so the port plans and moves the rows
itself. One process per rank; this module is the band plan and the
exchange:

- **Bands.** A tensor of H global rows is split over the S ranks of a
  spatial group: rank r holds rows ``[r H // S, (r + 1) H // S)``
  (``band``). Bands may be uneven, and they are empty where H < S (D0 at
  128 px with S = 4: P7 has one row, which rank 3 holds). Every activation
  is split by this one rule at its own height, so the bands of two levels
  need not line up (D7 at 1636 px: 204/102/51/25/12).
- **Row maps.** An op whose output rows read other input rows names them:
  ``Window(kernel, stride, pad)`` for a conv or a pool (output row i reads
  rows ``[i s - pad, i s - pad + k)``; rows outside [0, H) are the op's
  padding), ``Gather(src)`` for a nearest resize (output row i reads row
  ``src[i]``). From every rank's output band, the plan derives the rows
  each rank needs and which of them other ranks hold (``Exchange``, made
  once per op and heights and cached; it holds no tensor). The padding of
  the op (TF-SAME for the nominal size, or ``torch_padding``) goes only at
  the global top and bottom; an interior band edge gets the rows of the
  rank that holds them.
- **Exchange.** ``_FetchRows`` gathers from every rank one slab of fixed
  size: the first T rows of its band, which ranks above it read, and its
  last B rows, which ranks below it read, with T and B the largest such
  needs of the plan. That is one ``all_gather`` over the spatial group;
  each rank then takes the rows it needs from the slabs and its own band.
  The backward sends every fetched row's gradient back to the rank that
  holds the row, which adds it to the row's own gradient: each rank writes
  its fetched rows' gradients into the owners' slots of a zero buffer, and
  one float32 ``all_reduce`` over the group sums them. Where no rank needs
  another's rows (a 1x1 conv; a 2x resize whose bands line up) nothing is
  exchanged.
- **Collectives** are ``all_gather`` and ``all_reduce``, which NCCL and gloo
  both take. ``all_gather`` moves bytes (any dtype crosses), and over gloo
  it stages a CUDA tensor through host memory: ranks that share one card
  run over gloo. Every rank issues the same collectives in the same order:
  a rank with an empty band runs each op on filler rows and keeps none of
  its output, so its autograd graph, and so its backward's collectives,
  are those of the other ranks.

``SpatialPlan`` is one rank's view of the axis for one model: the group,
the rank's index, the image and pyramid heights, and the cached exchanges.
``parallel.mesh`` binds it to the model for the length of a step
(``EfficientDet.spatial``). The model reads it: the convs, resizes and
pools take a ``Band`` (the plan and the global height of their input), the
SE mean and the loss's per-image sums are summed over the group, and the
head gathers its serving outputs (``gather_levels``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..models.layers import _SumAcrossRanks, upsample_rows

def band(rows: int, index: int, size: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of a tensor of ``rows`` global rows that rank
    ``index`` of ``size`` holds."""
    return rows * index // size, rows * (index + 1) // size


@dataclasses.dataclass(frozen=True)
class Window:
    """Output row i reads input rows ``[i stride - pad, i stride - pad +
    kernel)``: a conv (``pad`` its top padding) or a pool."""
    kernel: int
    stride: int
    pad: int

    def span(self, a: int, b: int) -> Tuple[int, int]:
        return (a * self.stride - self.pad,
                (b - 1) * self.stride - self.pad + self.kernel)


@dataclasses.dataclass(frozen=True)
class Gather:
    """Output row i reads input row ``src[i]`` (non-decreasing): a nearest
    resize."""
    src: Tuple[int, ...]

    def span(self, a: int, b: int) -> Tuple[int, int]:
        return self.src[a], self.src[b - 1] + 1


RowMap = Union[Window, Gather]


@dataclasses.dataclass(frozen=True)
class Exchange:
    """One op's rows on one rank. The rank's output rows are ``[a, b)``;
    they read input rows ``[u, v)`` (clipped to the input) with ``top`` and
    ``bottom`` padding rows outside it. ``own`` is the slice of the rank's
    band among them; ``above`` and ``below`` index the rows ``[u, lo)`` and
    ``[hi, v)`` in the gathered slabs, each slab ``slab[0]`` rows from the
    top of its rank's band then ``slab[1]`` from its bottom. ``select``
    (``Gather`` maps) picks each output row's input row in ``[u, v)``."""
    a: int
    b: int
    u: int
    v: int
    top: int
    bottom: int
    own: Tuple[int, int]
    slab: Tuple[int, int]
    above: Tuple[int, ...]
    below: Tuple[int, ...]
    select: Optional[Tuple[int, ...]] = None

    @property
    def empty(self) -> bool:
        return self.a == self.b

    @property
    def moves(self) -> bool:
        """Whether any rank of the group reads another's rows (the same on
        every rank)."""
        return self.slab != (0, 0)


def plan_exchange(rows_in: int, rows_out: int, rowmap: RowMap, index: int,
                  size: int) -> Exchange:
    """Rank ``index``'s ``Exchange`` for an op from ``rows_in`` to
    ``rows_out`` global rows that reads by ``rowmap``, over ``size``
    ranks. Shape arithmetic alone."""
    bands = [band(rows_in, q, size) for q in range(size)]
    needs = []  # (a, b, u, v, top, bottom) per rank
    for q in range(size):
        a, b = band(rows_out, q, size)
        if a == b:
            needs.append((a, b, 0, 0, 0, 0))
            continue
        u, v = rowmap.span(a, b)
        needs.append((a, b, max(u, 0), min(v, rows_in), max(-u, 0),
                      max(v - rows_in, 0)))
    top_rows = bottom_rows = 0
    for q, (lo, hi) in enumerate(bands):
        for r, (_, _, u, v, _, _) in enumerate(needs):
            first, last = max(u, lo), min(v, hi)
            if r == q or first >= last:
                continue
            if r < q:   # rank r lies above: it reads the top of q's band
                top_rows = max(top_rows, last - lo)
            else:
                bottom_rows = max(bottom_rows, hi - first)
    a, b, u, v, top, bottom = needs[index]
    lo, hi = bands[index]
    width = top_rows + bottom_rows

    def slot(g: int) -> int:
        q = next(q for q, (l, h) in enumerate(bands) if l <= g < h)
        base = q * width
        if q > index:
            return base + g - bands[q][0]
        return base + width - (bands[q][1] - g)

    first = max(u, lo)
    select = None
    if isinstance(rowmap, Gather) and a < b:
        select = tuple(s - u for s in rowmap.src[a:b])
    return Exchange(a, b, u, v, top, bottom,
                    (first - lo, max(min(v, hi), first) - lo),
                    (top_rows, bottom_rows),
                    tuple(slot(g) for g in range(u, min(v, lo))),
                    tuple(slot(g) for g in range(max(u, hi), v)), select)


def make_slab(x: torch.Tensor, slab: Tuple[int, int]) -> torch.Tensor:
    """The rows of the rank's band ``x`` (N, C, h, W) that other ranks read:
    its first ``slab[0]`` rows, then its last ``slab[1]``, each part
    zero-filled where the band is shorter."""
    t, b = slab
    h = x.shape[2]
    first, last = min(t, h), min(b, h)
    n, c, _, w = x.shape
    fill = lambda k: x.new_zeros(n, c, k, w)
    return torch.cat([x[:, :, :first], fill(t - first), fill(b - last),
                      x[:, :, h - last:]], dim=2)


def assemble(x: torch.Tensor, slabs: torch.Tensor, ex: Exchange
             ) -> torch.Tensor:
    """Rows ``[u, v)`` from the rank's band ``x`` and every rank's slab
    concatenated in rank order along dim 2 (``slabs``), in x's memory
    format."""
    device = x.device
    index = lambda rows: torch.tensor(rows, dtype=torch.long, device=device)
    return torch.cat([slabs.index_select(2, index(ex.above)),
                      x[:, :, ex.own[0]:ex.own[1]],
                      slabs.index_select(2, index(ex.below))],
                     dim=2).contiguous(memory_format=_memory_format(x))


class _FetchRows(torch.autograd.Function):
    """The rows ``[u, v)`` of an ``Exchange`` from the rank's band: one
    ``all_gather`` of the slabs forward, one ``all_reduce`` of their
    gradients backward (module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, plan: "SpatialPlan", ex: Exchange):
        ctx.plan, ctx.ex, ctx.rows = plan, ex, x.shape[2]
        slabs = plan.all_gather(make_slab(x, ex.slab))
        return assemble(x, torch.cat(slabs, dim=2), ex)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        plan, ex, h = ctx.plan, ctx.ex, ctx.rows
        t, b = ex.slab
        n_above, n_own = len(ex.above), ex.own[1] - ex.own[0]
        g_above, g_own, g_below = grad.float().split(
            [n_above, n_own, len(ex.below)], dim=2)
        n, c, _, w = grad.shape
        sent = grad.new_zeros(n, c, plan.size * (t + b), w,
                              dtype=torch.float32)
        index = lambda rows: torch.tensor(rows, dtype=torch.long,
                                          device=grad.device)
        sent.index_add_(2, index(ex.above), g_above)
        sent.index_add_(2, index(ex.below), g_below)
        plan.all_reduce_(sent)
        mine = sent[:, :, plan.index * (t + b):(plan.index + 1) * (t + b)]
        dx = grad.new_zeros(n, c, h, w, dtype=torch.float32)
        dx[:, :, ex.own[0]:ex.own[1]] = g_own
        first, last = min(t, h), min(b, h)
        dx[:, :, :first] += mine[:, :, :first]
        dx[:, :, h - last:] += mine[:, :, t + b - last:]
        return dx.to(grad.dtype), None, None


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last
            if x.dim() == 4 and x.is_contiguous(
                memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


class _SumForward(torch.autograd.Function):
    """All-reduce SUM over a group whose backward passes each rank's
    gradient through unchanged. Every rank of the group computes the same
    value from the sum (the data rank's loss), and that value counts once:
    the gradient of a rank's own terms is the value's."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, plan: "SpatialPlan") -> torch.Tensor:
        x = x.clone()
        plan.all_reduce_(x)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (the same shape and dtype on every rank), in rank
    order, on ``t``'s device. The bytes cross, so any dtype does; over
    gloo a CUDA tensor goes through host memory."""
    size = dist.get_world_size(group)
    staged = (t.device.type == "cuda"
              and dist.get_backend(group) == dist.Backend.GLOO)
    flat = t.contiguous().reshape(-1)
    if staged:
        flat = flat.cpu()
    flat = flat.view(torch.uint8)
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    return [p.view(t.dtype).view(t.shape).to(t.device) for p in parts]


@dataclasses.dataclass(frozen=True)
class Band:
    """A tensor that is the rank's band of one with ``rows`` global rows,
    under ``plan``: what a conv, resize or pool needs to know of its
    input."""
    plan: "SpatialPlan"
    rows: int

    def at(self, rows: int) -> "Band":
        return Band(self.plan, rows)

    def fetch(self, x: torch.Tensor, rowmap: RowMap, rows_out: int
              ) -> Tuple[torch.Tensor, Exchange]:
        """(the input rows ``[u, v)`` that the rank's output rows read, and
        the ``Exchange``), exchanging rows with the group where any rank
        reads another's."""
        ex = self.plan.exchange(self.rows, rows_out, rowmap)
        if not ex.moves:
            return x[:, :, ex.own[0]:ex.own[1]], ex
        return _FetchRows.apply(x, self.plan, ex), ex

    def rows_for_upsample(self, x: torch.Tensor, rows_out: int
                          ) -> torch.Tensor:
        """The rows of x that the rank's band of its nearest 2x upsample
        (to ``rows_out`` rows) reads: ``layers.upsample_nearest_to``'s
        fetch, for a fusion kernel that upsamples them itself."""
        return self.fetch(x, Gather(upsample_rows(rows_out)), rows_out)[0]

    def rows_for_pool(self, x: torch.Tensor, rows_out: int) -> torch.Tensor:
        """The rows of x that the rank's band of its 2x2/2 VALID max pool
        (``rows_out`` rows) reads: ``layers.max_pool_2x2``'s fetch, for a
        fusion kernel that pools them itself."""
        return self.fetch(x, Window(2, 2, 0), rows_out)[0]

    def window(self, x: torch.Tensor, kernel: int, stride: int, pad: int,
               rows_out: int,
               op: Callable[[torch.Tensor, int, int], torch.Tensor]
               ) -> torch.Tensor:
        """The rank's band of a window op's output: ``op(t, top, bottom)``
        applies the op, with no padding in H of its own, to the rows ``t``
        that its band reads once ``top`` and ``bottom`` padding rows are
        added. An empty band runs the op on ``kernel`` filler rows and
        keeps none of its output."""
        t, ex = self.fetch(x, Window(kernel, stride, pad), rows_out)
        if ex.empty:
            return op(_with_filler(t, kernel), 0, 0)[:, :, :0]
        return op(t, ex.top, ex.bottom)

    def gather(self, x: torch.Tensor, src: Sequence[int], rows_out: int,
               op: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """The rank's band of a nearest resize whose output row i reads
        input row ``src[i]``: the rows it reads, picked per output row,
        then ``op`` (the resize in W, rows kept). An empty band runs
        ``op`` on one filler row and keeps none of its output."""
        t, ex = self.fetch(x, Gather(tuple(src)), rows_out)
        return gathered(t, ex, op)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The per-channel mean over the global (H, W) of (N, C, h, W),
        keepdim, in x's dtype: float32 sums added over the group
        (differentiable), over ``rows * W``."""
        s = _SumAcrossRanks.apply(x.sum(dim=(2, 3), keepdim=True,
                                        dtype=torch.float32),
                                  self.plan.group)
        return (s / (self.rows * x.shape[3])).to(x.dtype)


def _with_filler(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` (no rows) and ``rows`` zero rows: an empty band's input to an
    op whose output it drops, so that its graph is the other ranks'."""
    return torch.cat([t, t.new_zeros(t.shape[0], t.shape[1], rows,
                                     t.shape[3])], dim=2)


def gathered(t: torch.Tensor, ex: Exchange,
             op: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``Band.gather``'s local half, from the rows ``fetch`` gave."""
    if ex.empty:
        return op(_with_filler(t, 1))[:, :, :0]
    index = torch.tensor(ex.select, dtype=torch.long, device=t.device)
    return op(t.index_select(2, index).contiguous(
        memory_format=_memory_format(t)))


class SpatialPlan:
    """One rank's view of the spatial axis: the spatial ``group`` (rank
    ``index`` of ``size``), the exchanges made so far, and for a detector
    (``for_model``) the global heights of its images and of its pyramid
    levels (``pyramid``: (H, W) per level, the neck's outputs) and its
    anchors per cell."""

    def __init__(self, group, index: int, size: int, image_rows: int = 0,
                 pyramid: Sequence[Tuple[int, int]] = (),
                 anchors_per_cell: int = 0):
        self.group = group
        self.index = index
        self.size = size
        self.image_rows = image_rows
        self.pyramid = tuple(pyramid)
        self.anchors_per_cell = anchors_per_cell
        self._exchanges: Dict[tuple, Exchange] = {}

    @classmethod
    def for_model(cls, model, group, index: int, size: int
                  ) -> "SpatialPlan":
        """The plan of an ``EfficientDet`` whose head is a ``RetinaHead``;
        its geometry is taken once, by shape arithmetic on the ``meta``
        device."""
        from ..models.detector import pyramid_shapes_for_model
        from ..models.retina_head import RetinaHead
        from ..config import family_of
        if family_of(model.config.network) != "efficientdet":
            raise NotImplementedError(
                f"the spatial axis splits the EfficientNet and BiFPN's rows "
                f"only; {model.config.network}'s ResNet and FPN have no band "
                "plan: serve it on the data axis")
        if not isinstance(model.bbox_head, RetinaHead):
            raise NotImplementedError(
                f"the spatial axis runs the RetinaHead detector only, not "
                f"{type(model.bbox_head).__name__} (ROADMAP A17)")
        return cls(group, index, size, model.config.input_size,
                   pyramid_shapes_for_model(model),
                   model.config.num_anchors_per_cell)

    def band(self, rows: int) -> Tuple[int, int]:
        return band(rows, self.index, self.size)

    def image(self) -> Band:
        return Band(self, self.image_rows)

    def level(self, i: int) -> Band:
        return Band(self, self.pyramid[i][0])

    def exchange(self, rows_in: int, rows_out: int, rowmap: RowMap
                 ) -> Exchange:
        key = (rows_in, rows_out, rowmap)
        ex = self._exchanges.get(key)
        if ex is None:
            ex = plan_exchange(rows_in, rows_out, rowmap, self.index,
                               self.size)
            self._exchanges[key] = ex
        return ex

    # ------------------------------------------------------ collectives
    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        return all_gather(t, self.group)

    def all_reduce_(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, group=self.group)

    # ------------------------------------------------------------- head
    def band_anchors(self, anchor_levels: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Each level's anchors, (y, x, anchor) ordered, cut to the rank's
        rows of that level."""
        out = []
        for anchors, (h, w) in zip(anchor_levels, self.pyramid):
            lo, hi = self.band(h)
            per_row = w * self.anchors_per_cell
            out.append(anchors[lo * per_row:hi * per_row])
        return out

    def sum_loss_terms(self, *terms: torch.Tensor) -> Tuple[torch.Tensor,
                                                           ...]:
        """Per-image loss terms (each (B,)) summed over the group in one
        float32 all-reduce, each rank's gradient passed through
        (``_SumForward``)."""
        sums = _SumForward.apply(torch.stack([t.float() for t in terms]),
                                 self)
        return tuple(sums.unbind())

    def gather_levels(self, levels: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
        """The whole of each level from every rank's rows of it: levels
        [(B, n_l, K)] of the rank's band, (y, x, anchor) ordered, -> the
        global [(B, N_l, K)], the ranks' rows in rank order. One all-gather
        of the levels packed in float32 (exact for bf16 values and for
        class indices)."""
        counts = [[(hi - lo) * w * self.anchors_per_cell
                   for lo, hi in (band(h, q, self.size)
                                  for q in range(self.size))]
                  for h, w in self.pyramid[:len(levels)]]
        per_rank = [sum(c[q] for c in counts) for q in range(self.size)]
        b, k = levels[0].shape[0], levels[0].shape[2]
        mine = torch.cat([x.float() for x in levels], dim=1)
        pad = max(per_rank) - mine.shape[1]
        mine = torch.cat([mine, mine.new_zeros(b, pad, k)], dim=1)
        parts = self.all_gather(mine)
        out = []
        offsets = [0] * self.size
        for c in counts:
            rows = []
            for q in range(self.size):
                rows.append(parts[q][:, offsets[q]:offsets[q] + c[q]])
                offsets[q] += c[q]
            out.append(torch.cat(rows, dim=1))
        return out
