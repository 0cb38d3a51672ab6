"""The mesh's collectives, explicit: JAX's ``psum``/``pmean`` over a named
axis become ``all_reduce`` over the axis's process group.

- ``all_sum``/``all_mean``: tensors reduced as one flat float32 buffer (one
  collective per call, whatever their dtypes; each comes back in its own
  dtype), identical on every rank of the axis;
- ``sum_value``: the value summed over the axis, the gradient passed to the
  local term unchanged — what ``psum`` inside a differentiated
  ``shard_map`` body does (its transpose hands the replicated cotangent to
  each device's partial), and not what ``torch.distributed.nn.all_reduce``
  does (its backward all-reduces the cotangent, n times the gradient);
- ``sum_grad``: the identity whose gradient is summed over the axis — the
  cotangent a ``shard_map`` operand replicated over the axis receives;
- ``broadcast_``: rank ``src``'s tensors written over every rank's.

An axis of size 1 reduces nothing and launches no collective.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist


def _reduce(tensors, axis, mean: bool) -> List:
    tensors = list(tensors)
    live = [t for t in tensors if t is not None]
    if axis.size == 1 or not live:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in live])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=axis.group)
    if mean:
        flat = flat / float(axis.size)
    out, at = [], 0
    for t in tensors:
        if t is not None:
            n = t.numel()
            t = flat[at:at + n].view(t.shape).to(t.dtype)
            at += n
        out.append(t)
    return out


def all_sum(tensors: Iterable[Optional[torch.Tensor]], axis) -> List:
    """Each tensor summed over ``axis`` (None stays None)."""
    return _reduce(tensors, axis, False)


def all_mean(tensors: Iterable[Optional[torch.Tensor]], axis) -> List:
    """Each tensor averaged over ``axis``: the float32 sum divided by the
    axis size, then cast back."""
    return _reduce(tensors, axis, True)


class _SumValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.axis.group)
        return g, None


def sum_value(x: torch.Tensor, axis) -> torch.Tensor:
    """x summed over ``axis``; its gradient is the local term's alone."""
    return x if axis.size == 1 else _SumValue.apply(x, axis)


def sum_grad(x: torch.Tensor, axis) -> torch.Tensor:
    """x itself; its gradient is summed over ``axis``."""
    return x if axis.size == 1 else _SumGrad.apply(x, axis)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor in place with rank ``src``'s."""
    for t in tensors:
        with torch.no_grad():
            dist.broadcast(t.data, src=src)
