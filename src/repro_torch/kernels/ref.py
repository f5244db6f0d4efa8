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
           "conv_threshold_ref", "int_matmul"]


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
