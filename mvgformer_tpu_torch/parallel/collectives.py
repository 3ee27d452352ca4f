"""Collectives over one axis of the (data x view) grid, with the gradients
view parallelism needs.

JAX's view-sharded program (`make_mesh_2d` + `shard_batch(view_axis=)`)
gets its cross-view collectives from GSPMD. Here they are written out at
the points where the model needs every view: the mean over views, the
confidence softmax and the triangulation, the pooled features of the
query-adaptation inits, the MvP fusions and the criterion's reprojection
terms.

  * `all_reduce_sum(x, grid)`: the sum over the ranks of the axis; its
    backward is the sum over the ranks of the cotangents.
  * `all_reduce_max(x, grid)`: the elementwise max; its backward is the
    summed cotangent where this rank's value is the max.
  * `all_gather(x, grid, dim)`: the ranks' tensors concatenated along
    `dim` in rank order; its backward is a sum reduce-scatter, written as
    a sum all-reduce and this rank's slice (twice a reduce-scatter's
    bytes, but one call that every backend and torch version has).

Each is the identity where the axis has one rank (`grid` None, or a world
of 1 on that axis), and adds one to `COUNTS[f"{axis}.{kind}"]` per forward
call that communicates (a recomputed layer under remat counts again;
backwards do not count).

Why these backwards make the gradient exact. On a data row of n view
ranks every rank computes the same full loss L from the reduced and the
gathered tensors (the replicated part), and its own views' inputs to them
(the local part). Let c be the cotangent that reaches a collective's
output; it is the same on every rank of the row, because everything after
the collective is replicated.
  * Sum all-reduce, y = sum_r x_r: the true gradient of each x_r is c. The
    backward sums the n equal cotangents, so x_r receives n * c.
  * All-gather, y = cat_r x_r: the true gradient of x_r is c's slice r.
    The reduce-scatter sums the n equal cotangents and keeps slice r:
    n * (c's slice r).
  * Max all-reduce: the true gradient reaches the max's holder; the
    backward sums the cotangents there: n * c.
So every rank's local part receives n times its true gradient, and its
replicated part receives the true gradient itself. Summed over the row's
n ranks, a parameter's gradient is n * dL/dtheta: the replicated uses
count once per rank, n times in all, and each view's local use counts n
times on the one rank that holds it. `all_reduce_grads` divides the sum
over the whole grid by its world, data x n, which leaves the mean over the
data rows of dL/dtheta: the data-parallel gradient of one process per
data row that holds every view. The loss terms need no care: each rank of
a row reports the row's full loss, and their mean over the grid is the
mean over the rows. `tests/test_torch_view_parallel.py` holds this apart
from the model and through it.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.distributed as dist

COUNTS: collections.Counter = collections.Counter()

AXES = ("view", "data", "world")


def reset_counts() -> None:
    COUNTS.clear()


def axis_group(grid, axis: str):
    """(process group, ranks) of `grid`'s `axis`: 'view' (this data row),
    'data' (this view slot) or 'world'; (None, 1) where the axis has one
    rank."""
    if axis not in AXES:
        raise ValueError(f"unknown grid axis {axis!r}; one of {AXES}")
    if grid is None or not grid.distributed:
        return None, 1
    if axis == "view":
        return grid.view_group, grid.views
    if axis == "data":
        return grid.data_group, grid.data_world
    return grid.group, grid.world


def axis_size(grid, axis: str = "view") -> int:
    """The ranks of `grid`'s `axis` (1 without a grid)."""
    return axis_group(grid, axis)[1]


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _maxed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _gathered(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _SumAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _MaxAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = _maxed(x, group)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _summed(g, ctx.group) * (x == y).to(g.dtype), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.dim = group, dim
        ctx.size = x.shape[dim]
        ctx.index = dist.get_rank(group)
        return _gathered(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return (_summed(g, ctx.group).narrow(ctx.dim, ctx.index * ctx.size,
                                             ctx.size), None, None, None)


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce_sum(x: torch.Tensor, grid, axis: str = "view"
                   ) -> torch.Tensor:
    """The sum of `x` over the ranks of `grid`'s `axis`."""
    group, n = axis_group(grid, axis)
    if n == 1:
        return x
    COUNTS[f"{axis}.all_reduce_sum"] += 1
    if _wants_grad(x):
        return _SumAllReduce.apply(x, group)
    return _summed(x, group)


def all_reduce_max(x: torch.Tensor, grid, axis: str = "view"
                   ) -> torch.Tensor:
    """The elementwise max of `x` over the ranks of `grid`'s `axis`."""
    group, n = axis_group(grid, axis)
    if n == 1:
        return x
    COUNTS[f"{axis}.all_reduce_max"] += 1
    if _wants_grad(x):
        return _MaxAllReduce.apply(x, group)
    return _maxed(x, group)


def all_gather(x: torch.Tensor, grid, dim: int = 0, axis: str = "view"
               ) -> torch.Tensor:
    """The ranks' `x` of `grid`'s `axis` concatenated along `dim` in rank
    order (for the view axis: view order)."""
    group, n = axis_group(grid, axis)
    if n == 1:
        return x
    COUNTS[f"{axis}.all_gather"] += 1
    dim = dim % x.dim()
    if _wants_grad(x):
        return _AllGather.apply(x, group, n, dim)
    return _gathered(x, group, n, dim)


def view_mean(x: torch.Tensor, grid, num_views: Optional[int] = None
              ) -> torch.Tensor:
    """The mean over the views of `x` (V_local, ...), every view of the
    frame counted: the local sum in float32, summed over the view group,
    over the global view count, in `x`'s dtype. Without a view split,
    `x.mean(dim=0)`."""
    n = axis_size(grid)
    if n == 1:
        return x.mean(dim=0)
    total = all_reduce_sum(x.float().sum(dim=0), grid)
    return (total / (num_views or x.shape[0] * n)).to(x.dtype)


def view_sum(x: torch.Tensor, grid) -> torch.Tensor:
    """The sum over every view of the frame of `x` (V_local, ...): the
    local sum in float32, summed over the view group, in `x`'s dtype.
    Without a view split, `x.sum(dim=0)`."""
    if axis_size(grid) == 1:
        return x.sum(dim=0)
    return all_reduce_sum(x.float().sum(dim=0), grid).to(x.dtype)
