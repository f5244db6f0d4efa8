"""Shared LM building blocks, the dense subset: norms, embeddings, float
linears and the SwiGLU MLP.

The counterpart of ``repro.models.layers``: explicit init/apply pairs over
plain dicts of tensors, with the reference's parameter shapes and names so
that weights carry across (``repro_torch.models.model.params_from_numpy``).
Inits draw the reference's distributions from an explicit
``torch.Generator`` on an explicit device; JAX's PRNG values themselves
cannot be reproduced. Plain matmuls are ``torch.matmul``, as the reference
leaves them to XLA's ``dot_general``. The reference's ``shard(...)``
constraints are the identity on one card and are left out.

Not ported yet (``check_supported`` raises ``NotImplementedError``): MoE,
SSM and hybrid blocks, M-RoPE, embedding inputs (vlm/audio frontends),
QAT fake-quant (``weight_bits < 16``); the int8 serve path (``w_int``
params) is refused where weights enter the port,
``models.model.params_from_numpy``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's LM path does not
    run yet; it never silently takes another path."""
    missing = [what for what, bad in (
        ("MoE blocks", cfg.is_moe), ("SSM blocks", cfg.has_ssm),
        ("M-RoPE", cfg.mrope),
        ("embedding inputs (embed_inputs=False)", not cfg.embed_inputs),
        ("quantized weights (weight_bits < 16)", cfg.weight_bits < 16))
        if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port's LM path does not run {', '.join(missing)}"
            f" yet")


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
            truncated: bool) -> torch.Tensor:
    """float32 draw (truncated at +-2 sigma or not) scaled by ``std``, cast
    to the config's dtype, as the reference draws and casts."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if truncated:
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    else:
        w.normal_(generator=generator)
    return w.mul_(std).to(_dtype(cfg))


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
    """y = x @ w (+b), contracting x's last axis with w's first."""
    w = p["w"]
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
