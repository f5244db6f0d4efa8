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

The MoE (``moe_init`` / ``moe_apply``) is the reference's single-device
branch: top-k routing in float32, the Switch aux loss, capacity-limited
dispatch into an (E, C, d) buffer, the expert products as ``torch.bmm``
(``jnp.einsum`` in the reference, outside any Pallas kernel) and an
optional shared expert. The reference's ``shard_map`` branch waits for
``parallel/``. The int8 serve path (``w_int`` params) is not ported yet:
it is refused where weights enter the port,
``models.model.params_from_numpy``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.quantizers import IntQuantizer

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
    back to w's dtype; the gradient passes straight through."""
    w = p["w"]
    if cfg.weight_bits < 16:
        wq = IntQuantizer(bits=cfg.weight_bits, signed=True, narrow=True)
        w = wq(w.to(torch.float32)).to(w.dtype)
    y = torch.matmul(x, w.reshape(w.shape[0], -1))
    y = y.reshape(*x.shape[:-1], *w.shape[1:])
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_init(generator, cfg: ArchConfig, device=None):
    return {"table": _normal((cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                             cfg, generator, device, truncated=False)}


def embed_apply(cfg: ArchConfig, p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()].to(_dtype(cfg))


def head_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 through the tied table or a separate head."""
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


def moe_apply(cfg: ArchConfig, p, x):
    """Returns (y, aux_loss): the routed experts' combine (plus the shared
    expert) and the Switch load-balance loss."""
    E, k = cfg.moe_experts, cfg.moe_top_k
    probs, weights, idx = moe_route(cfg, p, x)
    me = probs.mean(dim=(0, 1))                                  # (E,)
    ce = torch.nn.functional.one_hot(idx, E).to(torch.float32).sum(
        dim=2).mean(dim=(0, 1)) / k
    aux = E * (me * ce).sum()
    y = _moe_local(cfg, x, idx, weights, p["wi_gate"], p["wi_up"], p["wo"])
    if cfg.moe_shared_expert:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux
