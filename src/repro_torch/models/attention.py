"""Attention: GQA + RoPE / sliding window, flash attention for long
sequences, and KV-cache decode.

The counterpart of ``repro.models.attention``, on torch tensors in the
reference's (B, S, H, hd) layout. ``chunked_attention`` — the reference's
online-softmax jnp twin of its Pallas flash kernel — calls the port's
flash attention kernel (``kernels.ops.flash_attention``): a launch on
CUDA tensors, the kernel's plain version on CPU tensors. ``attn_apply``
keeps the reference's dispatch: "chunked" runs the kernel, "naive" plain
torch ops, "auto" chunked when S > 2048. ``decode_attention`` and
``_decode_ring`` stay plain torch ops, as they are jnp in the reference.
M-RoPE is not ported yet (``layers.check_supported``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _dtype, linear_apply, linear_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(cfg: ArchConfig, positions: torch.Tensor):
    """positions (..., S) -> (cos, sin) of shape (..., S, hd//2)."""
    hd = cfg.hd
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, hd//2) (broadcast over heads)."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def positions_cos_sin(cfg: ArchConfig, positions: torch.Tensor):
    """positions: (B, S) int."""
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported yet")
    return rope_freqs(cfg, positions)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_init(generator, cfg: ArchConfig, device=None):
    H, K, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    return {
        "wq": linear_init(generator, d, (H, hd), cfg, bias=cfg.qkv_bias,
                          device=device),
        "wk": linear_init(generator, d, (K, hd), cfg, bias=cfg.qkv_bias,
                          device=device),
        "wv": linear_init(generator, d, (K, hd), cfg, bias=cfg.qkv_bias,
                          device=device),
        "wo": linear_init(generator, H * hd, d, cfg,
                          scale=(2 * cfg.n_layers * H * hd) ** -0.5,
                          device=device),
    }


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def mask_bias(cfg: ArchConfig, q_pos: torch.Tensor, k_pos: torch.Tensor
              ) -> torch.Tensor:
    """Additive mask bias: q_pos (Sq,), k_pos (Sk,) -> (Sq, Sk) float32."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if cfg.causal and not cfg.encoder_only:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if cfg.window > 0:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - cfg.window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


# ---------------------------------------------------------------------------
# core attention
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, bias):
    """q (B,Sq,H,hd), k/v (B,Sk,K,hd), bias (Sq,Sk) -> (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).to(torch.float32)
    scores = scores * (hd ** -0.5) + bias[None, None, None]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def _arange_offset(pos: torch.Tensor, name: str) -> int:
    """The offset of positions that must be ``offset + arange(n)``: the
    kernel takes implicit arange positions, as every call site of the
    reference passes them (its ``live_block_pairs`` assumes the same)."""
    offset = int(pos[0]) if pos.numel() else 0
    want = torch.arange(pos.numel(), device=pos.device) + offset
    if not torch.equal(pos.to(want.dtype), want):
        raise ValueError(f"{name} must be contiguous arange positions")
    return offset


def chunked_attention(cfg: ArchConfig, q, k, v, q_pos, k_pos):
    """Flash attention over (B, S, H, hd) tensors through the port's
    kernel (``ops.flash_attention``), with the config's causal and window
    masks. Positions must be arange runs with k_pos starting at 0; q_pos's
    start becomes the kernel's ``q_offset``. The heads move to axis 1 as
    strided views: the kernel reads the tensors in place and writes its
    output in the same layout."""
    if _arange_offset(k_pos, "k_pos") != 0:
        raise ValueError("k_pos must start at 0")
    q_offset = _arange_offset(q_pos, "q_pos")
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=cfg.causal and not cfg.encoder_only, window=cfg.window,
        q_offset=q_offset)
    return out.transpose(1, 2)


def decode_attention(cfg: ArchConfig, q, k_cache, v_cache, cur_index):
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, K, hd); cur_index: int or (B,) tensor
    = number of valid cache positions."""
    B, _, H, hd = q.shape
    S, Kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Kh, H // Kh, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).to(torch.float32) \
        * (hd ** -0.5)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    cur = torch.as_tensor(cur_index, device=q.device).expand(B)
    cur = cur[:, None, None, None]
    valid = pos[None, None, None, :] < cur
    if cfg.window > 0:
        valid = valid & (pos[None, None, None, :] >= cur - cfg.window)
    return _softmax_weighted(s, valid, v_cache).reshape(B, 1, H, hd)


def _softmax_weighted(s, valid, v_cache):
    """Explicit max / exp / sum / weighted sum of the reference's decode."""
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bskh->bkgh", (p / lsum).to(v_cache.dtype),
                        v_cache)


# ---------------------------------------------------------------------------
# full blocks
# ---------------------------------------------------------------------------

def attn_apply(cfg: ArchConfig, p, x, positions):
    """Training / prefill forward. x (B,S,d); positions (B,S)."""
    B, S, _ = x.shape
    q = linear_apply(cfg, p["wq"], x)
    k = linear_apply(cfg, p["wk"], x)
    v = linear_apply(cfg, p["wv"], x)
    cos, sin = positions_cos_sin(cfg, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if S > 2048 else "naive"
    if impl == "chunked":
        out = chunked_attention(cfg, q, k, v, positions[0], positions[0])
    else:
        bias = mask_bias(cfg, positions[0], positions[0])
        out = naive_attention(q, k, v, bias)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return linear_apply(cfg, p["wo"], out)


def attn_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
                    device=None):
    dtype = dtype or _dtype(cfg)
    cache_len = min(max_len, cfg.window) if cfg.window > 0 else max_len
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(cfg: ArchConfig, p, x, cache, cur_index):
    """One decode step. x (B,1,d); cur_index int or (B,) per-slot tensor.
    Returns (y, cache). The step's K/V are written into ``cache`` in place
    (the reference returns an updated copy; the port saves the copy of the
    whole cache per layer and step), so the returned cache is the one
    passed in."""
    B = x.shape[0]
    q = linear_apply(cfg, p["wq"], x)
    k = linear_apply(cfg, p["wk"], x)
    v = linear_apply(cfg, p["wv"], x)
    cur = torch.as_tensor(cur_index, dtype=torch.int32,
                          device=x.device).expand(B)
    cos, sin = positions_cos_sin(cfg, cur[:, None])
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    S = cache["k"].shape[1]
    write_idx = (torch.remainder(cur, S) if cfg.window > 0 else cur).long()
    bidx = torch.arange(B, device=x.device)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[bidx, write_idx] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, write_idx] = v[:, 0].to(v_cache.dtype)

    if cfg.window > 0:
        # ring buffer: every slot valid once cur_index >= S
        n_valid = torch.clamp(cur + 1, max=S)[:, None, None, None]
        out = _decode_ring(cfg, q, k_cache, v_cache, n_valid)
    else:
        out = decode_attention(cfg, q, k_cache, v_cache, cur + 1)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return linear_apply(cfg, p["wo"], out), cache


def _decode_ring(cfg, q, k_cache, v_cache, n_valid):
    """Window decode against a ring buffer: all slots < n_valid (broadcast
    (B,1,1,1)) are valid and already within the window by construction."""
    B, _, H, hd = q.shape
    S, Kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Kh, H // Kh, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).to(torch.float32) \
        * (hd ** -0.5)
    pos = torch.arange(S, dtype=torch.int32, device=q.device)
    valid = pos[None, None, None, :] < n_valid
    return _softmax_weighted(s, valid, v_cache).reshape(B, 1, H, hd)
