"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with plain tensor
operations that run on the CPU and on the card. The kernel wrappers in
``kernels.ops`` take them for CPU tensors; ``chip_smoke.py`` holds each
kernel against them on the card. They repeat the kernel's arithmetic and
are no yardstick of speed. Nothing on the CUDA main path calls them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.conv_threshold import conv_threshold_ref, int_matmul

__all__ = ["multi_threshold_ref", "threshold_matmul_ref",
           "mlp_megakernel_ref", "conv_threshold_ref", "int_matmul",
           "flash_attention_ref"]

NEG_INF = -1e30


def multi_threshold_ref(acc: torch.Tensor, thresholds: torch.Tensor
                        ) -> torch.Tensor:
    """FINN multi-threshold: out[..., c] = #{ i : acc[..., c] >= T[c, i] }.

    acc (..., C) int32; thresholds (C, S) int32 (sorted or not: the count
    is the same). Output (..., C) int32 in [0, S]."""
    return torch.sum(acc.unsqueeze(-1) >= thresholds, dim=-1,
                     dtype=torch.int32)


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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """Dense-softmax attention with GQA, causal and sliding-window masks.

    q (B, H, Sq, D), k/v (B, Hkv, Sk, D); query head h reads KV head
    h // (H / Hkv); query row i sits at position i + q_offset; keys at or
    beyond ``kv_len`` (default Sk) are masked. Scores, statistics and the
    weighted sum in float32, output in q's dtype. Masked scores are -1e30
    and weigh 0, and the sum is divided by max(l, 1e-30), so a row with no
    live key gives 0 (the kernel's rule)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    qg = q.reshape(b, hkv, h // hkv, sq, d).to(torch.float32)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.to(torch.float32)) * d ** -0.5
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(sk, device=q.device)
    ok = (k_pos < kv_len)[None, :].expand(sq, sk)
    if causal:
        ok = ok & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        ok = ok & (k_pos[None, :] > q_pos[:, None] - window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, sq, d).to(q.dtype)
