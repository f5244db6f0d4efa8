"""Collectives of the SPMD step, and the int8-compressed gradient
all-reduce.

The differentiable collectives, each a ``torch.autograd.Function`` over a
``torch.distributed`` process group (``parallel.sharding.logical_group``
gives the group that splits a logical axis), shared by the dense layers,
the loss and the MoE's mesh branch:

  * ``gather_blocks``: the FSDP all-gather of a parameter's blocks; its
    backward is the reduce-scatter (an all-reduce and a slice, which
    every backend has);
  * ``copy_to_group`` / ``sum_over_group``: Megatron's ``f`` and ``g``
    around a computation split over ranks that hold the same tokens and
    one loss (the identity with a summed backward; the summed partials
    with the gradient passed back as it is);
  * ``mean_over_group`` / ``sum_over_batch``: the mean / the sum of the
    batch group's values (the MoE's aux-loss means, the loss's
    numerators), on every rank; their backwards are their exact
    transposes, the group's cotangents summed (over its size for the
    mean). They hold the data-parallel convention of the SPMD step
    (``train.steps``): every rank of the batch group backprops its copy
    of the global loss, and the step sums the gradients of a parameter
    over the batch ranks that do not split it and divides every gradient
    by the batch group's size;
  * ``max_over_group``: the elementwise max, a constant under the
    gradient (the vocab-parallel log-sum-exp's shift).

Each skips itself (returns its input, no collective) on a group of None
or of one rank.

The compressed all-reduce, the counterpart of
``repro.parallel.collectives``: the paper's C1 insight
— quantize to the narrowest width the hardware moves natively — applied
to the interconnect: gradients are quantized to int8 codes at one scale
shared by every rank (the all-reduced max) before the data-parallel sum,
cutting its bytes 4x (f32) / 2x (bf16). An error-feedback buffer keeps
each rank's quantization residual for the next step.

The reference runs inside ``shard_map`` over the data axes; here every
rank is a process and the collectives run over ``group`` (a
``torch.distributed`` process group: the data axes of the mesh,
``parallel.sharding.axis_group``). The order of operations is the
reference's, so on one rank the result equals it bit for bit: the max
|g| all-reduced with MAX, ``scale = max(amax, 1e-12) / 127``, codes
``clip(round(g / scale), -127, 127)`` as int32, their SUM all-reduced
(exact), ``mean = total * (scale / axis_size)``, and the residual
``g - q * scale``. The codes travel as int32, as the reference's psum
has them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.pytree import leaves, unflatten_like


class _GatherBlocks(torch.autograd.Function):
    """All-gather of the group's blocks along ``dim`` (tiled, in rank
    order); the backward is its transpose, a reduce-scatter: the gradient
    summed over the group, the rank's block kept (an all-reduce and a
    slice, which every backend has)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.n = group, dim, n
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, gy):
        g = gy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


class _SumOverGroup(torch.autograd.Function):
    """The reference's ``psum`` over ranks that hold the same tokens and
    one loss: the SUM all-reduce of their partials, the output's gradient
    passed back as it is (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, gy):
        return gy, None


class _CopyToGroup(torch.autograd.Function):
    """The identity into a computation split over ranks that hold the
    same tokens and one loss; the backward sums the ranks' partial
    gradients (Megatron's ``f``, the transpose of ``_SumOverGroup``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        g = gy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _MeanOverGroup(torch.autograd.Function):
    """The mean of the group's values, on every rank; the backward is its
    exact transpose, the group's cotangents summed and divided by its
    size (so a cotangent that every rank holds comes back whole)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, dist.get_world_size(group)
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / ctx.n

    @staticmethod
    def backward(ctx, gy):
        g = gy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / ctx.n, None


def _over_group(fn, x, group, *args):
    """``fn`` over ``group``, or ``x`` itself on a group of one rank (no
    copy, no collective)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return fn.apply(x, group, *args)


class _SumOverBatch(torch.autograd.Function):
    """The SUM all-reduce of a value that every rank then holds as its
    own (a loss's numerator over the batch group); the backward is its
    exact transpose, the ranks' cotangents summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, gy):
        g = gy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def gather_blocks(x, group, dim: int):
    return _over_group(_GatherBlocks, x, group, dim)


def copy_to_group(x, group):
    return _over_group(_CopyToGroup, x, group)


def sum_over_group(x, group):
    return _over_group(_SumOverGroup, x, group)


def mean_over_group(x, group):
    return _over_group(_MeanOverGroup, x, group)


def sum_over_batch(x, group):
    return _over_group(_SumOverBatch, x, group)


def max_over_group(x, group):
    """The elementwise max over the group's ranks, detached."""
    y = x.detach()
    if group is None or dist.get_world_size(group) == 1:
        return y
    y = y.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def sum_detached(x, group):
    """The SUM all-reduce of a value outside the gradient (a count)."""
    y = x.detach()
    if group is None or dist.get_world_size(group) == 1:
        return y
    y = y.clone()
    dist.all_reduce(y, group=group)
    return y


def compressed_psum(g: torch.Tensor, group, axis_size: int):
    """(mean over the group's ranks in g's dtype, float32 residual)."""
    gf = g.to(torch.float32)
    amax = gf.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int32)
    total = q.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    mean = total.to(torch.float32) * (scale / axis_size)
    err = gf - q.to(torch.float32) * scale      # local quantization residual
    return mean.to(g.dtype), err


def compressed_psum_tree(grads, err_state, group, axis_size: int):
    """``compressed_psum`` leaf by leaf with error feedback.

    grads: the rank's gradient tree; err_state: a float32 tree of the same
    structure (or None at step 0). Returns (mean grads, new err state)."""
    flat = leaves(grads)
    errs = leaves(err_state) if err_state is not None else [None] * len(flat)
    outs, new_errs = [], []
    for g, e in zip(flat, errs):
        gin = g.to(torch.float32) + (e if e is not None else 0.0)
        mean, err = compressed_psum(gin, group, axis_size)
        outs.append(mean.to(g.dtype))
        new_errs.append(err)
    return unflatten_like(grads, outs), unflatten_like(grads, new_errs)


def collective_bytes_saved(grads, from_dtype=torch.float32) -> int:
    """Bytes saved per DP all-reduce by the int8 compression (reporting)."""
    n = sum(g.numel() for g in leaves(grads))
    return n * (torch.empty((), dtype=from_dtype).element_size() - 1)
