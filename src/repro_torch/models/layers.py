"""Shared LM building blocks: norms, embeddings, linears (float, or with
QAT fake-quant weights), the SwiGLU MLP and the top-k MoE.

The counterpart of ``repro.models.layers``: explicit init/apply pairs over
plain dicts of tensors, with the reference's parameter shapes and names so
that weights carry across (``repro_torch.models.model.params_from_numpy``).
Inits draw the reference's distributions from an explicit
``torch.Generator`` on an explicit device; JAX's PRNG values themselves
cannot be reproduced. Plain matmuls are ``torch.matmul``, as the reference
leaves them to XLA's ``dot_general``. The reference's ``shard(...)``
constraints are the identity on one card and are left out.

With ``weight_bits < 16`` every linear fake-quantizes its weight per
tensor with the port's straight-through ``IntQuantizer`` (QAT), as the
reference does.

The int8 serve path: ``quantize_linear_params`` turns a float linear into
int codes (``w_int``, int8, w's shape) and per-output-channel scales over
the fan-in axis (``w_scale``, float32, (1,) + w.shape[1:]). A linear that
holds ``w_int`` quantizes its input per tensor to int8 (plain torch, as
the reference's jnp outside any kernel; the whole (B, S, K) input shares
one scale, so a row's output depends on its batch, as in the reference)
and runs K5 (``kernels.ops.qmatmul``: int8 x int8 into int32, times the
per-channel scale ``s_x * w_scale`` formed in float32 first), so it
equals the reference's ``acc.astype(f32) * (s_x * w_scale)`` bit for bit
on equal inputs; then the cast to the config's dtype and the bias.

The MoE (``moe_init`` / ``moe_apply``): top-k routing in float32, the
Switch aux loss, capacity-limited dispatch into an (E, C, d) buffer, the
expert products as ``torch.bmm`` (``jnp.einsum`` in the reference,
outside any Pallas kernel) and an optional shared expert. Under a mesh
(``parallel.sharding.use_mesh_rules``) it takes the reference's
``shard_map`` branch in the SPMD form of one process a rank: each rank
passes its own tokens and its own blocks of the expert tensors (the
``fsdp`` axis of d, the ``model`` axis of d_ff); the blocks are gathered
over the fsdp group, the rank's tokens run through the local branch, and
the partial sums over d_ff are all-reduced over the model group. The
router and the shared expert are whole on every rank. ``moe_apply``
states how the gradients are split among the ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantizers import IntQuantizer
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import (active_mesh, active_rules,
                                           axis_group, batch_axes, model_axes)

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


def linear_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w (+b), contracting x's last axis with w's first. With
    ``cfg.weight_bits < 16`` w is fake-quantized first:
    narrow signed codes at a per-tensor min-max scale, in float32, cast
    back to w's dtype; the gradient passes straight through. A ``w_int``
    linear (the int8 serve path) runs on K5 instead."""
    if "w_int" in p:
        y = _int8_linear(cfg, p["w_int"], p["w_scale"], x)
    else:
        w = p["w"]
        if cfg.weight_bits < 16:
            wq = IntQuantizer(bits=cfg.weight_bits, signed=True, narrow=True)
            w = wq(w.to(torch.float32)).to(w.dtype)
        y = torch.matmul(x, w.reshape(w.shape[0], -1))
        y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in p:
        y = y + p["b"]
    return y


def _int8_linear(cfg: ArchConfig, w_int, w_scale, x):
    """The reference's ``w_int`` branch: x to int8 codes at one scale for
    the whole tensor (codes in [-128, 127], clamped before the cast),
    K5 over the flattened (M, K) x (K, N) codes with the per-channel scale
    ``s_x * w_scale`` (float32), reshaped and cast to the config's
    dtype."""
    x_int, s_x = IntQuantizer(bits=8, signed=True).quantize_int(
        x.to(torch.float32))
    k = x.shape[-1]
    scale = (s_x.reshape(()) * w_scale).reshape(-1)
    y = ops.qmatmul(x_int.reshape(-1, k), w_int.reshape(k, -1), scale)
    return y.reshape(*x.shape[:-1], *w_int.shape[1:]).to(_dtype(cfg))


def quantize_linear_params(p, bits: int = 8):
    """A float linear as the int serve form: narrow signed ``bits``-bit
    codes per output channel over the fan-in axis (``w_int``, int8, w's
    shape), their scales (``w_scale``, float32, (1,) + w.shape[1:]) and
    the bias, if any, as it is."""
    w = p["w"].to(torch.float32)
    q = IntQuantizer(bits=bits, signed=True, narrow=True, axis=0)
    w_int, s = q.quantize_int(w.reshape(w.shape[0], -1))
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


def embed_apply(cfg: ArchConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()].to(_dtype(cfg))


def head_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 through the tied table or a separate head; an
    int8 head (``w_int``) runs as a linear, so its logits pass through
    the config's dtype on the way, as in the reference."""
    if "w_int" in p:
        return linear_apply(cfg, p, x).to(torch.float32)
    w = p["table"].t() if "table" in p else p["w"]
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


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    g = linear_apply(cfg, p["wi_gate"], x)
    u = linear_apply(cfg, p["wi_up"], x)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return linear_apply(cfg, p["wo"], h)


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


def _moe_local(cfg: ArchConfig, x, idx, weights, wg, wu, wo):
    """Dispatch -> expert FFN -> combine, the reference's ``_moe_local``
    without a mesh.

    A choice's place in its expert is its rank among the (T*k) choices,
    token-major, that picked the same expert; choices ranked C or later are
    dropped: they go to the overflow row E*C and add nothing. Kept slots
    are unique, so the buffer is built by assignment (no atomics, the same
    under ``torch.use_deterministic_algorithms``); only the overflow row,
    which is cut off, can take several writes.
    """
    E, k = cfg.moe_experts, cfg.moe_top_k
    B, S, d = x.shape
    T = B * S
    flat_e = idx.reshape(-1)                                  # (T*k,)
    onehot = torch.nn.functional.one_hot(flat_e, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    C = moe_capacity(cfg, T)
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos.clamp(0, C - 1),
                       torch.full_like(flat_e, E * C))
    x_rep = x.reshape(T, d).repeat_interleave(k, dim=0)      # token-major
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = x_rep
    h = _expert_ffn(buf[:E * C].reshape(E, C, d), wg, wu, wo)
    flat_h = torch.cat([h.reshape(E * C, d), h.new_zeros((1, d))], dim=0)
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


def moe_apply(cfg: ArchConfig, p, x):
    """Returns (y, aux_loss): the routed experts' combine (plus the shared
    expert) and the Switch load-balance loss.

    Under a mesh, x is the rank's tokens and ``wi_gate`` / ``wi_up`` /
    ``wo`` its blocks (d over the fsdp axes, d_ff over the model axes):
    the blocks are gathered over the fsdp group, the rank's tokens
    dispatched with its own capacity, the partial sums over d_ff
    all-reduced over the model group, and the aux loss's two means taken
    over the batch group's tokens, as the reference's global ones.
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
    loss: x and the routing weights enter the d_ff-split experts by
    Megatron's ``f`` (its backward sums the ranks' partial gradients)
    and the partial outputs leave by its ``g``. Every rank of a group
    must take the aux loss into its loss, or none: its backward is a
    collective."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    probs, weights, idx = moe_route(cfg, p, x)
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = torch.nn.functional.one_hot(idx, E).to(torch.float32).sum(
        dim=2).mean(dim=(0, 1)) / k
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    mesh = active_mesh()
    if mesh is None:
        y = _moe_local(cfg, x, idx, weights, wg, wu, wo)
    else:
        group = axis_group(mesh, batch_axes())
        me = _over_group(_MeanOverGroup, me, group)
        ce = _over_group(_MeanOverGroup, ce, group)
        fsdp = active_rules().get("fsdp")
        if fsdp:      # FSDP all-gather (backward: reduce-scatter)
            group = axis_group(mesh, fsdp)
            wg = _over_group(_GatherBlocks, wg, group, 1)
            wu = _over_group(_GatherBlocks, wu, group, 1)
            wo = _over_group(_GatherBlocks, wo, group, 2)
        group = axis_group(mesh, model_axes())
        y = _moe_local(cfg, _over_group(_CopyToGroup, x, group), idx,
                       _over_group(_CopyToGroup, weights, group), wg, wu, wo)
        y = _over_group(_SumOverGroup, y, group)   # TP reduce over 'model'
    aux = E * (me * ce).sum()
    if cfg.moe_shared_expert:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux
