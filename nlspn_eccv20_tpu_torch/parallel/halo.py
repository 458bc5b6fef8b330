"""Halo exchanges between the strips of a width-sharded image.

Under width sharding (``num_spatial_shards > 1``, ``parallel/mesh.py``)
each rank of a space group holds a strip of the same images' columns. The
JAX package leaves the exchanges to XLA's SPMD partitioner, which adds a
halo around every conv and stencil of a sharded width; the port has no
partitioner, so the model asks for each halo by hand (``models/``):

* ``halo(x, strips, left, right)``: ``x`` with ``left`` columns of its left
  neighbour's strip before it and ``right`` columns of its right
  neighbour's after it, along the last dim (dim 3 of NCHW, dim 2 of a
  (B, H, W) plane). At the image's own edges it adds nothing, so each op
  keeps its own edge rule (zero padding, the pools' -inf, K1's replicate).
  Differentiable: its backward sends each halo column's gradient to the
  rank that owns the column, which adds it to its edge columns in a fixed
  order (its own first, then the left neighbour's, then the right's).
* ``extend(x, strips, left, right, pad)``: a conv's input, ``halo`` and
  ``pad`` zero columns at the image's own edges.
* ``gather_width(x, strips)``: the whole image on every rank of the group
  (outputs, summaries, tests); its backward keeps the rank's own columns of
  the gradients summed over the group.
* ``Strips.sum(t)``: ``t`` summed over the group, no gradient (the loss's
  and the metrics' valid-pixel counts).
* ``reach_and_widths(strips, need, width)``: the largest of the strips'
  ``need`` and every strip's width (the ``--offset`` steps' reach, which
  in eval depends on the offsets, and the route it takes: a halo, or the
  whole width where it passes the narrowest strip).

The exchanges are all-gathers over the space group: every backend takes
them, gloo on CUDA tensors too (it copies through the host), where a gloo
``send`` of a CUDA tensor aborts the process (seen on the H100's machine,
torch 2.11). Each rank lends the same
number of columns, so each strip must be at least as wide as the halo it
lends (``mesh.strip_bounds`` gives every strip 8 columns or more). A failed
exchange raises; nothing falls back to the whole image on one rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclass(frozen=True)
class Strips:
    """This rank's place among the ``count`` strips of its images: strip
    ``index`` (0 is the left edge), exchanged over ``group``, the process
    group of the space ranks that hold the same images."""

    index: int
    count: int
    group: Any = field(default=None, compare=False, repr=False)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.count - 1

    def took(self, left: int, right: int):
        """The columns ``halo(x, self, left, right)`` puts before and after
        this strip's own: none beyond the image's edges. A caller crops
        its extended output by them."""
        return (0 if self.first else left), (0 if self.last else right)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the strips' ranks (a copy; no gradient)."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t


def _all_gather(t: torch.Tensor, strips: Strips) -> List[torch.Tensor]:
    """Every strip's ``t`` (equal shapes), in strip order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(strips.count)]
    dist.all_gather(out, t, group=strips.group)
    return out


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, strips, left, right):
        ctx.strips, ctx.left, ctx.right = strips, left, right
        w = x.shape[-1]
        if w < max(left, right):
            raise ValueError(f"halo: a strip of {w} columns cannot lend "
                             f"{max(left, right)}")
        # my first `right` columns for my left neighbour, my last `left`
        # columns for my right neighbour
        got = _all_gather(torch.cat([x[..., :right], x[..., w - left:]], -1), strips)
        lo, hi = strips.took(left, right)
        parts = [x]
        if lo:
            parts.insert(0, got[strips.index - 1][..., right:])
        if hi:
            parts.append(got[strips.index + 1][..., :right])
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        strips, left, right = ctx.strips, ctx.left, ctx.right
        lo, hi = strips.took(left, right)
        w = g.shape[-1] - lo - hi
        back = g.new_zeros(g.shape[:-1] + (left + right,))
        # the gradients of my left halo (my left neighbour's last columns)
        # and of my right halo (my right neighbour's first columns)
        back[..., :lo] = g[..., :lo]
        back[..., left:left + hi] = g[..., lo + w:]
        got = _all_gather(back, strips)
        dx = g[..., lo:lo + w].clone()
        if right and not strips.first:
            dx[..., :right] += got[strips.index - 1][..., left:]
        if left and not strips.last:
            dx[..., w - left:] += got[strips.index + 1][..., :left]
        return dx, None, None, None


def halo(x: torch.Tensor, strips: Strips, left: int, right: int) -> torch.Tensor:
    """``x`` with ``left`` columns of the left neighbour's strip before it
    and ``right`` of the right neighbour's after it (none beyond the
    image's edges). Every rank of the group must call it with the same
    ``left`` and ``right``; with both 0 it exchanges nothing."""
    if not (left or right):
        return x
    return _Halo.apply(x, strips, left, right)


def extend(x: torch.Tensor, strips: Strips, left: int, right: int,
           pad: int) -> torch.Tensor:
    """A conv's input on a strip: ``halo(x, strips, left, right)``, then
    ``pad`` zero columns at the image's own left and right edges (the
    conv's own zero padding there)."""
    x = halo(x, strips, left, right)
    lo = pad if strips.first else 0
    hi = pad if strips.last else 0
    return F.pad(x, (lo, hi)) if lo or hi else x


class _GatherWidth(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, strips):
        ctx.strips = strips
        widths = [int(n) for n in _all_gather(
            torch.tensor([x.shape[-1]], device=x.device), strips)]
        ctx.span = (sum(widths[:strips.index]), x.shape[-1])
        top = max(widths)
        got = _all_gather(F.pad(x, (0, top - x.shape[-1])), strips)
        return torch.cat([t[..., :n] for t, n in zip(got, widths)], -1)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.strips.group)
        start, n = ctx.span
        return g[..., start:start + n], None


def gather_width(x: torch.Tensor, strips: Strips) -> torch.Tensor:
    """The whole image's columns on every rank of the group: the strips of
    ``x`` put side by side along the last dim. Differentiable: the
    gradient of a rank's strip is its columns of the gradients summed over
    the group (each rank's loss may read the whole tensor)."""
    return _GatherWidth.apply(x, strips)


def reach_and_widths(strips: Strips, need: torch.Tensor, width: int):
    """The largest ``need`` (a 0-d tensor, a column count) over the group
    and every strip's width in strip order, from one all-gather: the same
    on every rank, so each takes the same route. A ``need`` that is not
    finite raises."""
    got = _all_gather(torch.stack([need.to(torch.float32).reshape(()),
                                   need.new_tensor(width, dtype=torch.float32)]), strips)
    pairs = [t.tolist() for t in got]
    return int(max(n for n, _ in pairs)), [int(c) for _, c in pairs]


def gather_tree(obj, strips: Strips):
    """``obj`` with every 4-D tensor (NCHW strips) replaced by its whole
    width (``gather_width``), through dicts, lists and tuples; other values
    as they are. Every rank of the group must call it on the same
    structure."""
    if isinstance(obj, torch.Tensor):
        return gather_width(obj, strips) if obj.dim() == 4 else obj
    if isinstance(obj, dict):
        return {k: gather_tree(v, strips) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(gather_tree(v, strips) for v in obj)
    return obj
