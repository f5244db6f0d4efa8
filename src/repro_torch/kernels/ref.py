"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with plain tensor
operations that run on the CPU and on the card. The kernel wrappers in
``kernels.ops`` take them for CPU tensors; ``chip_smoke.py`` holds each
kernel against them on the card. They repeat the kernel's arithmetic and
are no yardstick of speed. Nothing on the CUDA main path calls them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.conv_threshold import conv_threshold_ref, int_matmul

__all__ = ["multi_threshold_ref", "threshold_matmul_ref",
           "mlp_megakernel_ref", "conv_threshold_ref", "int_matmul",
           "flash_attention_ref", "flash_attention_bwd_ref", "qmatmul_ref",
           "float_head_ref"]

NEG_INF = -1e30


def multi_threshold_ref(acc: torch.Tensor, thresholds: torch.Tensor
                        ) -> torch.Tensor:
    """FINN multi-threshold: out[..., c] = #{ i : acc[..., c] >= T[c, i] }.

    acc (..., C) int32; thresholds (C, S) int32 (sorted or not: the count
    is the same). Output (..., C) int32 in [0, S]."""
    return torch.sum(acc.unsqueeze(-1) >= thresholds, dim=-1,
                     dtype=torch.int32)


def qmatmul_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                scale: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                relu: bool = False,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """Fused int8 stage: exact integer matmul, per-channel dequant, bias,
    optional ReLU, optional requant to int8.

    x_int (M, K) int8, w_int (K, N) int8, scale and bias (N,) float32.
    The Pallas kernel's order and roundings (``repro.kernels.qmatmul``):
    the int32 accumulator cast to float32, times ``scale``, plus ``bias``
    (zeros when None), each op rounded on its own; the requant multiplies
    by the float32 reciprocal of ``out_scale``, rounds half to even and
    clips to [-128, 127]. Returns (M, N) float32, or int8 when
    ``out_scale`` is set."""
    y = int_matmul(x_int, w_int).to(torch.float32) * scale.reshape(1, -1)
    y = y + (bias.reshape(1, -1) if bias is not None
             else torch.zeros_like(scale).reshape(1, -1))
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_scale is None:
        return y
    # the float32 reciprocal as a Python scalar: torch multiplies float32
    # tensors by it in float32 (and, unlike a tensor, it needs no copy to
    # the card, so the call can be captured in a CUDA graph)
    inv = float(np.float32(1.0 / out_scale))
    return torch.clamp(torch.round(y * inv), -128, 127).to(torch.int8)


def float_head_ref(x_int: torch.Tensor, w: torch.Tensor, in_scale: float,
                   b: torch.Tensor) -> torch.Tensor:
    """The deployed float head, the reference's expression
    (``FloatHeadStage.apply_ref``): x_int as float32 @ w, times
    ``in_scale``, plus ``b``. Its matrix product's reduction order is the
    library's, which may depend on the row count."""
    return x_int.to(torch.float32) @ w * in_scale + b


def threshold_matmul_ref(x_int: torch.Tensor, w_int: torch.Tensor,
                         thresholds: torch.Tensor) -> torch.Tensor:
    """Fused integer dense stage: exact integer matmul, then the count.

    x_int (M, K) int codes, w_int (K, N) int8, thresholds (N, S) int32."""
    return multi_threshold_ref(int_matmul(x_int, w_int), thresholds)


def mlp_megakernel_ref(x_int: torch.Tensor, weights, banks) -> torch.Tensor:
    """A run of fused dense stages, one after the other: the chain of
    ``threshold_matmul_ref`` that the megakernel computes in one launch.

    x_int (M, K_0) int codes; weights[d] (K_d, N_d) int8 with K_{d+1} = N_d;
    banks[d] (S_d, N_d) int32, step-major as the kernel takes them.
    Returns the last stage's (M, N_last) int32 codes."""
    h = x_int
    for w, b in zip(weights, banks):
        h = threshold_matmul_ref(h, w, b.t())
    return h


def _flash_live(sq: int, sk: int, causal: bool, window: int, q_offset: int,
                kv_len: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: key j is live for query row i (K6's mask)."""
    q_pos = torch.arange(sq, device=device) + q_offset
    k_pos = torch.arange(sk, device=device)
    ok = (k_pos < kv_len)[None, :].expand(sq, sk)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    return ok


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_len=None,
                        return_lse: bool = False):
    """Dense-softmax attention with GQA, causal and sliding-window masks.

    q (B, H, Sq, D), k/v (B, Hkv, Sk, D); query head h reads KV head
    h // (H / Hkv); query row i sits at position i + q_offset; keys at or
    beyond ``kv_len`` (default Sk) are masked. Scores, statistics and the
    weighted sum in float32, output in q's dtype. Masked scores are -1e30
    and weigh 0, and the sum is divided by max(l, 1e-30), so a row with no
    live key gives 0 (the kernel's rule). With ``return_lse`` also the
    per-row log-sum-exp of the scaled live scores, (B, H, Sq) float32,
    +inf on a row with no live key (so exp(s - lse) is 0 there)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    qg = q.reshape(b, hkv, h // hkv, sq, d).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * d ** -0.5
    ok = _flash_live(sq, sk, causal, window, q_offset, kv_len, q.device)
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    lsum = p.sum(dim=-1, keepdim=True)
    out = (out / lsum.clamp_min(1e-30)).reshape(b, h, sq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(lsum > 0, m + torch.log(lsum), float("inf"))
    return out, lse.reshape(b, h, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0,
                            q_offset: int = 0, kv_len=None):
    """The backward of ``flash_attention_ref`` by its explicit formulas, in
    float32: with s = D^-1/2 q k^T over the live keys,

      P = exp(s - lse) (the softmax, rebuilt from the forward's lse),
      dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dO * O)),
      dQ = D^-1/2 dS K, dK = D^-1/2 dS^T Q,

    dK and dV summed over the query heads that share a KV head. q, o, dO
    (B, H, Sq, D), k, v (B, Hkv, Sk, D), lse (B, H, Sq) float32. Returns
    (dq, dk, dv) in q's, k's and v's dtypes. A row with no live key has P
    = 0, so it gets zero gradients and adds nothing to dK and dV."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    g = h // hkv
    scale = d ** -0.5

    def grouped(t):
        return t.reshape(b, hkv, g, sq, d).to(torch.float32)

    qf, of, dof = grouped(q), grouped(o), grouped(do)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    ok = _flash_live(sq, sk, causal, window, q_offset, kv_len, q.device)
    p = torch.where(ok, torch.exp(s - lse.reshape(b, hkv, g, sq, 1)), 0.0)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
