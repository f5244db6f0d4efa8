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
           "mlp_megakernel_ref", "conv_threshold_ref", "int_matmul"]


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
