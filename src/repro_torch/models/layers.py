"""Shared LM building blocks: norms, embeddings, linears (float, or with
QAT fake-quant weights), the SwiGLU MLP and the top-k MoE.

The counterpart of ``repro.models.layers``: explicit init/apply pairs over
plain dicts of tensors, with the reference's parameter shapes and names so
that weights carry across (``repro_torch.models.model.params_from_numpy``).
Inits draw the reference's distributions from an explicit
``torch.Generator`` on an explicit device; JAX's PRNG values themselves
cannot be reproduced. Plain matmuls are ``torch.matmul``, as the reference
leaves them to XLA's ``dot_general``.

Under a mesh (``parallel.sharding.use_mesh_rules``) the layers run in the
SPMD form of one process a rank, where the reference's GSPMD partitions
along its ``shard(...)`` constraints: each rank holds the blocks of the
parameters that the spec trees give, gathers the ``fsdp`` blocks before
use (``parallel.collectives.gather_blocks``, whose backward is the
reduce-scatter), and splits the work over the groups of the active rules
(``parallel.sharding.logical_group``): the MLP's ``wi_gate`` / ``wi_up``
by columns and ``wo`` by rows over "mlp", its input in through Megatron's
``f`` and its output out through ``g``; the embedding's vocab rows over
"vocab" (a token outside the rank's block looks up zeros, and the
lookups are summed over the group); the head's logits over "vocab" (the
loss is vocab-parallel, ``models.model``). A group of one rank, or a
logical axis the rules leave unsplit, runs the plain code. Where the
rules split the residual stream's sequence ("seq", the seqpar strategy),
a split computation's input is the rank's sequence block, gathered on
the way in, and its output is reduce-scattered back onto the block
(``enter_split`` / ``leave_split``).

With ``weight_bits < 16`` every linear fake-quantizes its weight per
tensor with the port's straight-through ``IntQuantizer`` (QAT), as the
reference does; a weight split over ranks takes the scale of the whole
tensor (the block's max |w| reduced over the group that splits it).

The int8 serve path: ``quantize_linear_params`` turns a float linear into
int codes (``w_int``, int8, w's shape) and per-output-channel scales over
the fan-in axis (``w_scale``, float32, (1,) + w.shape[1:]). A linear that
holds ``w_int`` quantizes its input per tensor to int8 (plain torch, as
the reference's jnp outside any kernel; the whole (B, S, K) input shares
one scale, so a row's output depends on its batch, as in the reference)
and runs K5 (``kernels.ops.qmatmul``: int8 x int8 into int32, times the
per-channel scale ``s_x * w_scale`` formed in float32 first), so it
equals the reference's ``acc.astype(f32) * (s_x * w_scale)`` bit for bit
on equal inputs; then the cast to the config's dtype and the bias. A
row-parallel linear split over ranks (``row_parallel_linear``) runs K5's
accumulator mode instead and sums the int32 blocks over its group
before that one rescale, as the reference's GSPMD all-reduces its int32
dot, so the mesh's output is one rank's bit for bit.

Each init has a sibling ``*_specs`` that returns the same tree with a
sharding spec at every leaf: a plain tuple, as
``parallel.sharding.logical_to_spec`` gives it (an entry is None, a mesh
axis or a tuple of them), built from the logical rules active at the call
(``use_mesh_rules``), the reference's ``PartitionSpec`` tree entry for
entry. The dry run (``launch.dryrun``) reads them for the per-device
bytes.

The MoE (``moe_init`` / ``moe_apply``): top-k routing in float32, the
Switch aux loss, capacity-limited dispatch into an (E, C, d) buffer, the
expert products as ``torch.bmm`` (``jnp.einsum`` in the reference,
outside any Pallas kernel) and an optional shared expert. Under a mesh
(``parallel.sharding.use_mesh_rules``) it takes the reference's
``shard_map`` branch in the SPMD form of one process a rank: each rank
passes its own tokens and its own blocks of the expert tensors (the
``fsdp`` axis of d, the ``mlp`` axis of d_ff); the blocks are gathered
over the fsdp group, the rank's tokens run through the local branch, and
the partial sums over d_ff are all-reduced over the mlp group; under
expert parallelism (the ep strategy) each rank runs its whole experts
instead. The router is whole on every rank; the shared expert is a dense
MLP, split as ``mlp_apply`` splits it. ``moe_apply`` states how the
gradients are split among the ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantizers import IntQuantizer
from repro_torch.kernels import ops
from repro_torch.parallel.collectives import (copy_to_group, gather_blocks,
                                              gather_sequence,
                                              gather_sequence_whole,
                                              max_over_group,
                                              mean_over_group,
                                              scatter_sequence_sum,
                                              sequence_block,
                                              sum_over_group)
from repro_torch.parallel.sharding import (active_mesh, active_rules,
                                           local_dim, logical_block,
                                           logical_group, same_split)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


#: the parameter leaves (by the tail of their path) that are float32 in
#: every config, as in the reference
FLOAT32_LEAVES = (("router", "w"), ("A_log",), ("D",), ("dt_proj", "b"))


def leaf_dtype(cfg: ArchConfig, path) -> torch.dtype:
    """The reference's dtype of the parameter leaf at ``path`` (its dict
    keys, from the root or from any subtree): the one owner of that choice,
    read by the inits and by ``model.params_from_numpy``."""
    path = tuple(path)
    if any(path[-len(tail):] == tail for tail in FLOAT32_LEAVES):
        return torch.float32
    return _dtype(cfg)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(cfg: ArchConfig, device=None):
    d = cfg.d_model
    p = {"scale": torch.ones(d, dtype=_dtype(cfg), device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros(d, dtype=_dtype(cfg), device=device)
    return p


def _mx(logical):
    """A logical axis as a 1-tuple of its spec entry (mesh axes or None),
    to splice into a spec tuple: the reference's ``_mx``."""
    r = active_rules().get(logical)
    if r is None:
        return (None,)
    return (r if not (isinstance(r, tuple) and len(r) == 1) else r[0],)


def norm_specs(cfg: ArchConfig):
    if cfg.norm == "ln":
        return {"scale": (), "bias": ()}
    return {"scale": ()}


def norm_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """RMS or layer norm, computed in float32, returned in x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "ln":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * p["scale"].to(torch.float32)
                + p["bias"].to(torch.float32)).to(x.dtype)
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + cfg.norm_eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# float linear
# ---------------------------------------------------------------------------

def _normal(shape, std: float, cfg: ArchConfig, generator, device,
            truncated: bool, dtype: Optional[torch.dtype] = None
            ) -> torch.Tensor:
    """float32 draw (truncated at +-2 sigma or not) scaled by ``std``, cast
    to ``dtype`` (None: the config's), as the reference draws and casts."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if truncated:
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    else:
        w.normal_(generator=generator)
    return w.mul_(std).to(dtype or _dtype(cfg))


def linear_init(generator, in_dim: int, out_shape, cfg: ArchConfig,
                bias: bool = False, scale: Optional[float] = None,
                device=None):
    """Weight (in_dim, *out_shape); trunc-normal init (1/sqrt(fan_in))."""
    out_shape = out_shape if isinstance(out_shape, tuple) else (out_shape,)
    std = scale if scale is not None else in_dim ** -0.5
    p = {"w": _normal((in_dim, *out_shape), std, cfg, generator, device,
                      truncated=True)}
    if bias:
        p["b"] = torch.zeros(out_shape, dtype=_dtype(cfg), device=device)
    return p


def linear_apply(cfg: ArchConfig, p, x: torch.Tensor,
                 fsdp_dim: Optional[int] = None, split=None) -> torch.Tensor:
    """y = x @ w (+b), contracting x's last axis with w's first. With
    ``cfg.weight_bits < 16`` w is fake-quantized first:
    narrow signed codes at a per-tensor min-max scale, in float32, cast
    back to w's dtype; the gradient passes straight through. A ``w_int``
    linear (the int8 serve path) runs on K5 instead.

    Under a mesh: w's "fsdp" blocks along ``fsdp_dim`` are gathered
    first (``w_int``'s, and ``w_scale``'s where that axis is its output
    channels'); ``split`` is the group over which w is a block (tensor
    parallelism), whose max |w| sets the fake-quant scale."""
    if "w_int" in p:
        w_int, w_scale = p["w_int"], p["w_scale"]
        if fsdp_dim is not None:
            fsdp = logical_group("fsdp")
            w_int = gather_blocks(w_int, fsdp, fsdp_dim)
            if fsdp_dim > 0:
                w_scale = gather_blocks(w_scale, fsdp, fsdp_dim)
        y = _int8_linear(cfg, w_int, w_scale, x)
    else:
        w = p["w"]
        if fsdp_dim is not None:
            w = gather_blocks(w, logical_group("fsdp"), fsdp_dim)
        if cfg.weight_bits < 16:
            wq = IntQuantizer(bits=cfg.weight_bits, signed=True, narrow=True)
            wf = w.to(torch.float32)
            scale = (None if split is None else wq.scale(
                max_over_group(wf.abs().amax(), split)))
            w = wq(wf, scale).to(w.dtype)
        y = torch.matmul(x, w.reshape(w.shape[0], -1))
        y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in p:
        y = y + p["b"]
    return y


def enter_split(x: torch.Tensor, name: str, seq=None) -> torch.Tensor:
    """x into a computation split over the group of the logical axis
    ``name``, whose ranks hold the same tokens and one loss: Megatron's
    ``f`` (the identity; its backward sums the ranks' partial
    gradients). Where x is the rank's block of the sequence (``seq``, the
    "seq" group), the blocks are gathered first: where ``name`` splits
    over the same axes, the gather is ``f`` itself (its backward the
    reduce-scatter); otherwise the computation repeats on every rank of
    ``seq`` and the gather's backward keeps the rank's block."""
    tp = logical_group(name)
    if seq is None:
        return copy_to_group(x, tp)
    if tp is not None and same_split(name, "seq"):
        return gather_sequence(x, seq)
    return copy_to_group(gather_sequence_whole(x, seq), tp)


def leave_split(y: torch.Tensor, name: str, seq=None) -> torch.Tensor:
    """The partial outputs of a computation split over the logical axis
    ``name``'s group summed over it (Megatron's ``g``; any dtype, the
    int8 path's int32 accumulators too): all-reduced, or, where the
    residual stream is split into sequence blocks over the same axes
    (``seq``), reduce-scattered onto the rank's block; a whole output
    (``name`` not split) keeps the rank's block of the sequence."""
    tp = logical_group(name)
    if seq is None:
        return sum_over_group(y, tp)
    if tp is not None and same_split(name, "seq"):
        return scatter_sequence_sum(y, seq)
    return sequence_block(sum_over_group(y, tp), seq)


def row_parallel_linear(cfg: ArchConfig, p, x: torch.Tensor, name: str,
                        seq=None) -> torch.Tensor:
    """A linear whose w is split along its fan-in over the logical axis
    ``name``'s group (the MLP's and attention's ``wo``, the SSM's
    ``x_proj`` and ``out_proj``): w's "fsdp" blocks along dim 1 are
    gathered first, x is the rank's block of the contraction axis, and
    the partial outputs leave by ``leave_split`` (summed over the group,
    or reduce-scattered onto the rank's sequence block where ``seq`` is
    given).

    The int8 path (``w_int``) takes the activation's scale over the group
    too, so the codes are those of the whole input. Split over ranks, its
    K5 call returns the int32 accumulator (the kernel's accumulator
    mode), the group sums the int32 blocks, and the one rescale follows:
    the reference's ``acc.astype(f32) * (s_x * w_scale)`` of the whole
    contraction, so the output equals one rank's bit for bit. Whole on
    the rank, K5's fused epilogue does the same in one pass."""
    group = logical_group(name)
    if "w_int" not in p or group is None:
        return leave_split(linear_apply(cfg, p, x, 1, group), name, seq)
    fsdp = logical_group("fsdp")
    w_int = gather_blocks(p["w_int"], fsdp, 1)
    w_scale = gather_blocks(p["w_scale"], fsdp, 1)
    x_int, s_x = _int8_codes(x, group)
    k = x.shape[-1]
    acc = ops.qmatmul(x_int.reshape(-1, k), w_int.reshape(k, -1), None)
    acc = leave_split(acc.reshape(*x.shape[:-1], -1), name, seq)
    y = acc.to(torch.float32) * (s_x.reshape(()) * w_scale).reshape(-1)
    y = y.reshape(*acc.shape[:-1], *w_int.shape[1:]).to(_dtype(cfg))
    if "b" in p:
        y = y + p["b"]
    return y


def _int8_codes(x, split=None):
    """x as int8 codes at one scale for the whole tensor (codes in [-128,
    127], clamped before the cast) and that scale. Under a mesh x is a
    block of the whole tensor, the rank's rows of the batch (and, where
    ``split`` is given, its block of the contraction axis): the scale is
    the max over those groups, so the codes are the ones the whole tensor
    gives."""
    q = IntQuantizer(bits=8, signed=True)
    xf = x.to(torch.float32)
    scale = None
    if active_mesh() is not None:
        scale = max_over_group(max_over_group(q.scale(xf),
                                              logical_group("batch")), split)
    return q.quantize_int(xf, scale)


def _int8_linear(cfg: ArchConfig, w_int, w_scale, x):
    """The reference's ``w_int`` branch: x to int8 codes
    (``_int8_codes``), K5 over the flattened (M, K) x (K, N) codes with
    the per-channel scale ``s_x * w_scale`` (float32), reshaped and cast
    to the config's dtype."""
    x_int, s_x = _int8_codes(x)
    k = x.shape[-1]
    scale = (s_x.reshape(()) * w_scale).reshape(-1)
    y = ops.qmatmul(x_int.reshape(-1, k), w_int.reshape(k, -1), scale)
    return y.reshape(*x.shape[:-1], *w_int.shape[1:]).to(_dtype(cfg))


def quantize_linear_params(p, bits: int = 8, group=None):
    """A float linear as the int serve form: narrow signed ``bits``-bit
    codes per output channel over the fan-in axis (``w_int``, int8, w's
    shape), their scales (``w_scale``, float32, (1,) + w.shape[1:]) and
    the bias, if any, as it is. ``group``: the ranks over which w's
    fan-in is split (w a block of the whole weight), whose max per
    channel sets the scales."""
    w = p["w"].to(torch.float32)
    q = IntQuantizer(bits=bits, signed=True, narrow=True, axis=0)
    w2 = w.reshape(w.shape[0], -1)
    scale = None if group is None else max_over_group(q.scale(w2), group)
    w_int, s = q.quantize_int(w2, scale)
    out = {"w_int": w_int.reshape(w.shape).to(torch.int8),
           "w_scale": s.reshape((1,) + tuple(w.shape[1:])).to(torch.float32)}
    if "b" in p:
        out["b"] = p["b"]
    return out


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_init(generator, cfg: ArchConfig, device=None):
    return {"table": _normal((cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                             cfg, generator, device, truncated=False)}


def embed_specs(cfg: ArchConfig):
    return {"table": (*_mx("vocab"), *_mx("fsdp"))}


def embed_apply(cfg: ArchConfig, p, tokens: torch.Tensor,
                seq=None) -> torch.Tensor:
    """The table's rows of ``tokens``. Under a mesh that splits the vocab,
    the rank's rows of the table look up the tokens in its block, the
    others zeros, and the lookups are summed over the group (one rank
    adds a row, so the sum is exact). ``seq``: the group over which the
    residual stream is split into sequence blocks; the rank's block is
    returned (the sum then a reduce-scatter, ``leave_split``)."""
    table = gather_blocks(p["table"], logical_group("fsdp"), 1)
    if logical_group("vocab") is None:
        x = table[tokens.long()].to(_dtype(cfg))
    else:
        rows = table.shape[0]
        local = tokens.long() - logical_block("vocab")[0] * rows
        mine = ((local >= 0) & (local < rows))[..., None]
        x = torch.where(mine, table[local.clamp(0, rows - 1)],
                        0.0).to(_dtype(cfg))
    return leave_split(x, "vocab", seq)


def head_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 through the tied table or a separate head; an
    int8 head (``w_int``) runs as a linear, so its logits pass through
    the config's dtype on the way, as in the reference. Under a mesh that
    splits the vocab: the rank's block of the logits."""
    if "w_int" in p:
        return linear_apply(cfg, p, x, fsdp_dim=0).to(torch.float32)
    fsdp = logical_group("fsdp")
    if "table" in p:
        w = gather_blocks(p["table"], fsdp, 1).t()
    else:
        w = gather_blocks(p["w"], fsdp, 0)
    x = copy_to_group(x, logical_group("vocab"))
    return torch.matmul(x, w).to(torch.float32)


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_init(generator, cfg: ArchConfig, device=None):
    return {
        "wi_gate": linear_init(generator, cfg.d_model, cfg.d_ff, cfg,
                               device=device),
        "wi_up": linear_init(generator, cfg.d_model, cfg.d_ff, cfg,
                             device=device),
        "wo": linear_init(generator, cfg.d_ff, cfg.d_model, cfg,
                          scale=(2 * cfg.n_layers * cfg.d_ff) ** -0.5,
                          device=device),
    }


def mlp_specs(cfg: ArchConfig):
    in_spec = (*_mx("fsdp"), *_mx("mlp"))
    out_spec = (*_mx("mlp"), *_mx("fsdp"))
    return {"wi_gate": {"w": in_spec}, "wi_up": {"w": in_spec},
            "wo": {"w": out_spec}}


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor, seq=None
              ) -> torch.Tensor:
    """SwiGLU; under a mesh the rank's d_ff block (column-parallel in,
    row-parallel out, the partial outputs summed over the "mlp" group).
    ``seq``: x is the rank's block of the sequence over that group
    (``enter_split`` gathers it, the output is reduce-scattered back)."""
    return row_parallel_linear(cfg, p["wo"], _swiglu(
        cfg, p, enter_split(x, "mlp", seq)), "mlp", seq)


def _swiglu(cfg: ArchConfig, p, x):
    """The MLP's hidden activations on the rank's d_ff block."""
    tp = logical_group("mlp")
    g = linear_apply(cfg, p["wi_gate"], x, fsdp_dim=0, split=tp)
    u = linear_apply(cfg, p["wi_up"], x, fsdp_dim=0, split=tp)
    return torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity-limited dispatch, expert FFNs)
# ---------------------------------------------------------------------------

def moe_init(generator, cfg: ArchConfig, device=None):
    """The router (float32 whatever ``cfg.dtype``: ``leaf_dtype``), E
    experts' SwiGLU weights stacked on a leading axis, and the shared
    expert if the config has one."""
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
    std_in = d ** -0.5
    std_out = (2 * cfg.n_layers * f) ** -0.5
    p = {
        "router": {"w": _normal((d, E), std_in, cfg, generator, device,
                                truncated=False,
                                dtype=leaf_dtype(cfg, ("router", "w")))},
        "wi_gate": _normal((E, d, f), std_in, cfg, generator, device,
                           truncated=False),
        "wi_up": _normal((E, d, f), std_in, cfg, generator, device,
                         truncated=False),
        "wo": _normal((E, f, d), std_out, cfg, generator, device,
                      truncated=False),
    }
    if cfg.moe_shared_expert:
        p["shared"] = mlp_init(generator, cfg, device=device)
    return p


def moe_specs(cfg: ArchConfig):
    ein = (*_mx("experts"), *_mx("fsdp"), *_mx("mlp"))
    eout = (*_mx("experts"), *_mx("mlp"), *_mx("fsdp"))
    p = {"router": {"w": ()}, "wi_gate": ein, "wi_up": ein, "wo": eout}
    if cfg.moe_shared_expert:
        p["shared"] = mlp_specs(cfg)
    return p


def _expert_ffn(x_ecd, wg, wu, wo):
    """x: (E, C, d); weights (E, d, f) / (E, f, d) -> (E, C, d)."""
    g = torch.bmm(x_ecd, wg)
    u = torch.bmm(x_ecd, wu)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x_ecd.dtype) * u
    return torch.bmm(h, wo)


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens (at least 1)."""
    return max(int(n_tokens * cfg.moe_top_k * cfg.capacity_factor
                   / cfg.moe_experts), 1)


def _moe_local(cfg: ArchConfig, x, idx, weights, wg, wu, wo,
               first: int = 0):
    """Dispatch -> expert FFN -> combine, the reference's ``_moe_local``
    without a mesh; ``wg`` / ``wu`` / ``wo`` hold the experts ``first``
    .. ``first + len(wg) - 1`` (all of them but under expert
    parallelism).

    A choice's place in its expert is its rank among the (T*k) choices,
    token-major, that picked the same expert, counted over all E experts
    by their global ids; choices ranked C or later are dropped, and so,
    under expert parallelism, are the choices of experts the rank does
    not hold: they go to the overflow row El*C and add nothing. Kept
    slots are unique, so the buffer is built by assignment (no atomics,
    the same under ``torch.use_deterministic_algorithms``); only the
    overflow row, which is cut off, can take several writes.
    """
    E, k = cfg.moe_experts, cfg.moe_top_k
    El = wg.shape[0]
    B, S, d = x.shape
    T = B * S
    flat_e = idx.reshape(-1)                                  # (T*k,)
    onehot = torch.nn.functional.one_hot(flat_e, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    C = moe_capacity(cfg, T)
    local_e = flat_e - first
    keep = (pos < C) & (local_e >= 0) & (local_e < El)
    slot = torch.where(keep, local_e * C + pos.clamp(0, C - 1),
                       torch.full_like(flat_e, El * C))
    x_rep = x.reshape(T, d).repeat_interleave(k, dim=0)      # token-major
    buf = x.new_zeros((El * C + 1, d))
    buf[slot] = x_rep
    h = _expert_ffn(buf[:El * C].reshape(El, C, d), wg, wu, wo)
    flat_h = torch.cat([h.reshape(El * C, d), h.new_zeros((1, d))], dim=0)
    gate = (weights.reshape(-1) * keep.to(torch.float32))[:, None]
    y = flat_h[slot] * gate.to(h.dtype)
    return y.reshape(T, k, d).sum(dim=1).reshape(B, S, d)


def moe_route(cfg: ArchConfig, p, x):
    """(probs (B, S, E), weights (B, S, k), idx (B, S, k)), in float32.
    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them:
    ``torch.topk`` promises no order among equal values, a stable
    descending sort does."""
    logits = torch.matmul(x.to(torch.float32), p["router"]["w"])
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    weights, idx = vals[..., :k], order[..., :k]
    return probs, weights / weights.sum(dim=-1, keepdim=True), idx


def moe_apply(cfg: ArchConfig, p, x, seq=None):
    """Returns (y, aux_loss): the routed experts' combine (plus the shared
    expert) and the Switch load-balance loss.

    Under a mesh, x is the rank's tokens and ``wi_gate`` / ``wi_up`` /
    ``wo`` its blocks (d over the fsdp axes; d_ff over the mlp axes, or,
    under expert parallelism, the experts over the "experts" axes): the
    blocks are gathered over the fsdp group, the rank's tokens dispatched
    with its own capacity, the aux loss's two means taken over the batch
    group's tokens, as the reference's global ones, and:

      * d_ff split (the baseline): every expert runs on the rank's d_ff
        block and the partial sums are all-reduced over the mlp group;
      * experts split (the ep strategy): every rank of the group holds
        the same tokens, routes them all and numbers each expert's
        choices over all E, exactly as one rank does, but dispatches only
        the choices of its own ``E / M`` experts, runs their whole d_ff
        and combines; the partial sums are all-reduced over the group.
        E must split into the group's blocks (``ValueError`` otherwise,
        where the reference's jit refuses the sharding).

    ``seq``: x is the rank's block of the sequence, split over that
    group (the seqpar strategy): it is gathered first, so the routing,
    each choice's place in its expert, the drops and the capacity are
    those of the data shard's whole sequence, and the output is
    reduce-scattered back, the shared expert's partial output folded
    into the same collective where it is split over the same group.
    Collectives over a group of one rank are skipped.

    Gradients under a mesh: each rank backprops its own loss (the mean
    over its tokens, plus the aux loss, which every rank holds whole), and
    the global loss is the mean of the data ranks' losses. Over the data
    ranks each backward is the exact transpose of the forward for the
    sum of those losses: a block gathered over the fsdp group gets the
    group's summed gradient (a reduce-scatter), the aux loss's means hand
    each rank the group's summed cotangent over its size, and a
    replicated parameter gets the rank's own term, so the data group's
    mean of the ranks' gradients (the DDP step's) is the global loss's
    gradient. The ranks of a model group hold the same tokens and one
    loss: x and the routing weights enter the split experts by
    Megatron's ``f`` (its backward sums the ranks' partial gradients)
    and the partial outputs leave by its ``g``. Every rank of a group
    must take the aux loss into its loss, or none: its backward is a
    collective."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    x = gather_sequence_whole(x, seq)
    probs, weights, idx = moe_route(cfg, p, x)
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = torch.nn.functional.one_hot(idx, E).to(torch.float32).sum(
        dim=2).mean(dim=(0, 1)) / k
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    mesh = active_mesh()
    split = "mlp"
    if mesh is None:
        y = _moe_local(cfg, x, idx, weights, wg, wu, wo)
    else:
        group = logical_group("batch")
        me = mean_over_group(me, group)
        ce = mean_over_group(ce, group)
        fsdp = logical_group("fsdp")  # FSDP all-gather (bwd: reduce-scatter)
        wg = gather_blocks(wg, fsdp, 1)
        wu = gather_blocks(wu, fsdp, 1)
        wo = gather_blocks(wo, fsdp, 2)
        first = 0
        if logical_group("experts") is not None:
            split = "experts"
            first = logical_block("experts")[0] * local_dim("experts", E)
        tp = logical_group(split)
        y = _moe_local(cfg, copy_to_group(x, tp), idx,
                       copy_to_group(weights, tp), wg, wu, wo, first)
    aux = E * (me * ce).sum()
    if cfg.moe_shared_expert:
        sp = p["shared"]
        tp = logical_group("mlp")
        h = _swiglu(cfg, sp, copy_to_group(x, tp))
        if split != "mlp" or "w_int" in sp["wo"]:
            # split over another group, or int8 (whose partial int32
            # sums are rescaled only once summed): a collective of its own
            return (leave_split(y, split, seq)
                    + row_parallel_linear(cfg, sp["wo"], h, "mlp", seq), aux)
        y = y + linear_apply(cfg, sp["wo"], h, 1, tp)
    return leave_split(y, split, seq), aux
