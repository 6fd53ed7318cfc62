"""Width halos: the counterpart of ``width_halo_exchange``
(``rangedet_tpu/models/layers.py:325-347``).

Under width sharding each rank of a width group holds columns
``[m*W, (m+1)*W)`` of the range image. ``width_halo(x, h, group)`` returns
``(..., W + 2h)``: the left neighbour's last h columns, x, the right
neighbour's first h. The first and last ranks receive zeros, the global
SAME zero padding, so "exchange -> the unmodified zero-padding op -> slice
the interior" reproduces the unsharded op (``models/layers.py``,
``models/meta_kernel.py``). With a width group of one it is the zero pad
(``layers.py:339-341``).

JAX exchanges with two ``ppermute``s. The port exchanges with one
``all_reduce`` over the width group of a zero-filled (M, 2, ..., h) slot
buffer in which rank m writes only its own two slots, its first and last
h columns: every element is one rank's value plus zeros, so the sum is
the value. ``all_reduce`` is the collective that both backends run on
CUDA tensors (gloo runs no ``send``/``recv`` there), so the exchange is the
same on every backend. The backward is ppermute's transpose through the
same exchange: the gradient of each received halo goes back to the rank
that sent it and is added onto its edge columns; the gradient of a zero
pad is dropped.

Every exchange is one collective, counted in ``dist.COLLECTIVES``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from . import dist as pdist


def _exchange(first: torch.Tensor, last: torch.Tensor, group
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank m gives its neighbours ``first`` (to m-1) and ``last`` (to
    m+1). -> (what m-1 gave to m, what m+1 gave to m); zeros where there
    is no neighbour."""
    n, m = tdist.get_world_size(group), tdist.get_rank(group)
    slots = first.new_zeros((n, 2) + tuple(first.shape))
    slots[m, 0] = first
    slots[m, 1] = last
    pdist._all_reduce(slots, group)
    from_left = slots[m - 1, 1] if m > 0 else torch.zeros_like(last)
    from_right = slots[m + 1, 0] if m < n - 1 else torch.zeros_like(first)
    return from_left, from_right


class WidthHalo(torch.autograd.Function):
    """(..., W) -> (..., W + 2h) over a width group of two or more ranks.
    The forward exchanges the edges; the backward sends each halo's
    gradient back to the rank it came from, which adds it onto its edge
    columns."""

    @staticmethod
    def forward(ctx, x, h, group):
        ctx.h, ctx.group = h, group
        left, right = _exchange(x[..., :h], x[..., -h:], group)
        return torch.cat([left, x, right], dim=-1)

    @staticmethod
    def backward(ctx, g):
        h = ctx.h
        gx = g[..., h:-h].contiguous()
        from_left, from_right = _exchange(g[..., :h], g[..., -h:], ctx.group)
        gx[..., :h] += from_left
        gx[..., -h:] += from_right
        return gx, None, None


def width_halo(x: torch.Tensor, h: int, group) -> torch.Tensor:
    """x (..., W) with h halo columns on each side from the neighbours in
    ``group`` (zeros at the image's edges); differentiable. A group of one
    pads zeros and issues no collective. The Function is looked up on this
    module at call time, so a patched one routes every exchange."""
    if tdist.get_world_size(group) == 1:
        return F.pad(x, (h, h))
    return WidthHalo.apply(x, h, group)
