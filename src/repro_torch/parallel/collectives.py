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
    gradient (the vocab-parallel log-sum-exp's shift);
  * ``exchange_column_blocks``: the all-to-all that turns a rank's
    contiguous column block of a tensor made of ``parts`` equal parts
    along its last axis (the mamba ``in_proj``'s ``[xs | z]``) into the
    rank's block of each part; its backward is the inverse all-to-all;
  * ``combine_softmax``: forward only (decode), the partial softmaxes
    of a group's key blocks combined: the running max all-reduced with
    MAX, the rescaled sums and weighted sums with SUM;
  * the sequence-parallel collectives (Megatron's pair, and the two ends
    of a replicated computation), over the group whose ranks hold the
    blocks of the sequence axis of the residual stream (the "seq" rule),
    block r on group rank r:

      - ``gather_sequence``: the blocks all-gathered into the whole
        sequence that enters a computation split over the same group;
        its backward is the reduce-scatter of the ranks' partial
        gradients onto the rank's block;
      - ``scatter_sequence_sum``: the ranks' partial sums reduce-scattered
        onto the rank's block of the sequence (the row-parallel output,
        int32 accumulators too); its backward is the all-gather;
      - ``gather_sequence_whole``: the blocks all-gathered into the whole
        sequence that a computation every rank repeats reads (the
        router, the final norm); every rank then holds the whole
        gradient, and its backward keeps the rank's block of it;
      - ``sequence_block``: the rank's block of a tensor every rank holds
        whole; its backward is the all-gather of the blocks' gradients.

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


def _all_gather_dim(x, group, dim):
    """The group's blocks of ``x`` concatenated along ``dim``, in rank
    order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter_dim(x, group, dim):
    """The group's sum of ``x``, this rank's block of it along ``dim``:
    one reduce-scatter (the blocks laid out along the leading axis, as
    ``reduce_scatter_tensor`` takes them)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"sequence of {x.shape[dim]} does not split into "
                         f"{n} blocks")
    buf = x.movedim(dim, 0).contiguous()
    out = buf.new_empty((buf.shape[0] // n, *buf.shape[1:]))
    dist.reduce_scatter_tensor(out, buf, group=group)
    return out.movedim(0, dim)


def _rank_block(x, group, dim):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"sequence of {x.shape[dim]} does not split into "
                         f"{n} blocks")
    w = x.shape[dim] // n
    return x.narrow(dim, r * w, w)


class _GatherSequence(torch.autograd.Function):
    """All-gather of the sequence blocks; backward: reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, gy):
        return _reduce_scatter_dim(gy, ctx.group, ctx.dim), None, None


class _ScatterSequenceSum(torch.autograd.Function):
    """Reduce-scatter of partial sums onto the rank's block; backward:
    all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter_dim(x, group, dim)

    @staticmethod
    def backward(ctx, gy):
        return _all_gather_dim(gy, ctx.group, ctx.dim), None, None


class _GatherSequenceWhole(torch.autograd.Function):
    """All-gather of the sequence blocks into a computation every rank
    repeats; backward: the rank's block of the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, gy):
        return (_rank_block(gy, ctx.group, ctx.dim).contiguous(), None,
                None)


class _SequenceBlock(torch.autograd.Function):
    """The rank's block of a tensor every rank holds whole; backward:
    all-gather of the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _rank_block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, gy):
        return _all_gather_dim(gy, ctx.group, ctx.dim), None, None


def gather_sequence(x, group, dim: int = 1):
    return _over_group(_GatherSequence, x, group, dim)


def scatter_sequence_sum(x, group, dim: int = 1):
    return _over_group(_ScatterSequenceSum, x, group, dim)


def gather_sequence_whole(x, group, dim: int = 1):
    return _over_group(_GatherSequenceWhole, x, group, dim)


def sequence_block(x, group, dim: int = 1):
    return _over_group(_SequenceBlock, x, group, dim)


def _exchange_plan(parts: int, m: int, r: int):
    """Rank ``r`` of ``m`` holds chunks ``r * parts`` .. ``(r + 1) * parts
    - 1`` of the ``parts * m`` equal column chunks, and needs chunk
    ``p * m + r`` of each part p. Returns (the chunks it holds, in the
    order it sends them: by destination ``j % m``; the chunks it sends
    to each rank; the chunks it receives from each rank). The chunks it
    receives arrive by source, then by index: part by part."""
    mine = range(r * parts, (r + 1) * parts)
    send = sorted(mine, key=lambda j: (j % m, j))
    to = [sum(1 for j in mine if j % m == q) for q in range(m)]
    want = [p * m + r for p in range(parts)]
    frm = [sum(1 for j in want if j // parts == s) for s in range(m)]
    return send, to, frm


def _all_to_all_last(x, group, out_chunks, in_chunks, width):
    """``all_to_all_single`` along the last axis, in chunks of ``width``
    columns: ``in_chunks[q]`` chunks of x go to rank q, ``out_chunks[s]``
    arrive from rank s, in rank order."""
    buf = x.movedim(-1, 0).contiguous()
    out = buf.new_empty((sum(out_chunks) * width, *buf.shape[1:]))
    dist.all_to_all_single(out, buf, [n * width for n in out_chunks],
                           [n * width for n in in_chunks], group=group)
    return out.movedim(0, -1)


class _ExchangeColumnBlocks(torch.autograd.Function):
    """The rank's contiguous block of columns -> its chunk of each of
    the ``parts`` parts (``exchange_column_blocks``); the backward sends
    each chunk's gradient back where the chunk came from."""

    @staticmethod
    def forward(ctx, x, group, parts):
        m, r = dist.get_world_size(group), dist.get_rank(group)
        width = x.shape[-1] // parts
        send, to, frm = _exchange_plan(parts, m, r)
        ctx.group, ctx.width, ctx.plan = group, width, (r, parts, send, to,
                                                        frm)
        chunks = x.split(width, dim=-1)
        x = torch.cat([chunks[j - r * parts] for j in send], dim=-1)
        return _all_to_all_last(x, group, frm, to, width)

    @staticmethod
    def backward(ctx, gy):
        r, parts, send, to, frm = ctx.plan
        g = _all_to_all_last(gy, ctx.group, to, frm, ctx.width)
        chunks = g.split(ctx.width, dim=-1)
        order = sorted(range(parts), key=lambda i: send[i])
        return torch.cat([chunks[i] for i in order], dim=-1), None, None


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


def exchange_column_blocks(x, group, parts: int = 2):
    """x (..., w): this rank's contiguous block, rank by rank, of the
    last axis of a tensor made of ``parts`` equal parts along it (the
    mamba ``in_proj``'s output ``[xs | z]``, whose columns the weight's
    ("fsdp", "model") spec splits in one piece). Returns the rank's
    block of each part, concatenated part by part: on rank r of m, the
    columns ``[r * w / parts, (r + 1) * w / parts)`` of every part.
    One all-to-all; differentiable (its backward is the inverse one)."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    if x.shape[-1] % parts:
        raise ValueError(f"{x.shape[-1]} columns do not split into "
                         f"{parts} parts")
    return _ExchangeColumnBlocks.apply(x, group, parts)


def combine_softmax(m, lsum, acc, group):
    """Combine the partial softmaxes of the group's key blocks, forward
    only: ``m`` the block's max score, ``lsum`` its sum of exp(s - m),
    ``acc`` its sum of exp(s - m) v (``m`` and ``lsum`` broadcast against
    ``acc``). Returns sum_r acc_r e^(m_r - M) / sum_r lsum_r e^(m_r - M),
    M the group's max: one MAX and one SUM all-reduce (the sums and the
    weighted sums in one buffer). A block with no valid key has m = -inf
    in effect (the mask's -1e30) and weighs 0."""
    if group is None or dist.get_world_size(group) == 1:
        return acc / lsum
    big = max_over_group(m, group)
    w = torch.exp(m - big)
    n = acc.shape[-1]
    both = torch.cat([acc * w, (lsum * w).expand(*acc.shape[:-1], 1)],
                     dim=-1)
    dist.all_reduce(both, group=group)
    return both[..., :n] / both[..., n:]


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
