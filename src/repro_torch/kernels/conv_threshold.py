"""Host side of the fused direct-conv + multi-threshold stage.

The CUDA kernel is ``csrc/conv_threshold.cu`` (it replaces the Pallas
``repro.kernels.conv_threshold.conv_threshold``); ``kernels.ops`` launches
it. This module holds what surrounds it and what the CPU tests reach: the
SAME pad split, the row-block plan, the host padding the wrapper applies
before a launch, and the plain PyTorch version of the whole stage
(shifted-window tap sums into an exact integer accumulator, then the
threshold count), which the CPU path runs and ``chip_smoke.py`` holds the
kernel against.

Weight layout is shared with the im2col path: ``w2d`` is the
(kh*kw*cin, cout) matrix with feature order (kh, kw, c) row-major, so tap
(kh, kw) owns rows ``[(kh*K + kw)*C, (kh*K + kw + 1)*C)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def same_pad_1d(n: int, out: int, stride: int, kernel: int) -> Tuple[int, int]:
    """SAME zero-pad of one axis: (low, high), low side floor(pad/2)."""
    p = max((out - 1) * stride + kernel - n, 0)
    return p // 2, p - p // 2


def same_pads(h: int, w: int, out_h: int, out_w: int, stride: int,
              kernel: int):
    """XLA/TF SAME zero-pad widths: ((low_h, high_h), (low_w, high_w)).

    Low side gets floor(pad/2). The one pad split every conv path uses
    (im2col, the direct CPU path, the kernel's host wrapper);
    ``torch.nn.functional.conv2d(padding="same")`` rejects stride > 1 and is
    not used."""
    return (same_pad_1d(h, out_h, stride, kernel),
            same_pad_1d(w, out_w, stride, kernel))


def pad_nhwc(x: torch.Tensor, pad_h, pad_w, value=0) -> torch.Tensor:
    """Pad the H and W axes of an NHWC tensor (any dtype)."""
    return F.pad(x, (0, 0, pad_w[0], pad_w[1], pad_h[0], pad_h[1]),
                 value=value)


def band_rows(block_h: int, stride: int, kernel: int) -> int:
    """Input rows one output-row block reads: body rows plus the halo the
    K x K taps reach past the block boundary."""
    return (block_h - 1) * stride + kernel


# The reference's TPU row-block heuristic, kept so both packages cut a conv
# into the same row blocks: about this many output pixels per block, with
# the block's int32 accumulator tile under this many bytes (a VMEM budget on
# the TPU). The CUDA kernel keeps one accumulator per thread in a register;
# here the plan only sets the grid's row count.
TARGET_ROWS = 256
ACC_BUDGET_BYTES = 1 << 21


def plan_conv_blocks(out_h: int, out_w: int, out_ch: int) -> int:
    """Pick the output-row block (``repro.kernels.ops.plan_conv_blocks``).

    Enough rows that a block's ``block_h * out_w`` output pixels approach
    ``TARGET_ROWS``, capped so ``block_h * out_w * out_ch * 4`` stays within
    ``ACC_BUDGET_BYTES``. At least 1 row, never more than ``out_h``. On the
    card one thread block covers one (sample, row block)."""
    block_h = max(1, min(out_h, TARGET_ROWS // max(out_w, 1)))
    while (block_h > 1
           and block_h * out_w * max(out_ch, 1) * 4 > ACC_BUDGET_BYTES):
        block_h -= 1
    return block_h


def pad_input(x: torch.Tensor, *, kernel: int, stride: int, padding: str,
              out_h: int, out_w: int) -> torch.Tensor:
    """Zero-pad NHWC codes for a conv: the SAME split (``same_pads``), or
    nothing for VALID. Exact on integer codes whenever code 0 means value 0
    (the export contract). Unlike the Pallas wrapper, the CUDA kernel masks
    the rows of its last row block that lie past ``out_h``, so no bottom
    rows are added for the row-block grid."""
    if padding != "SAME":
        return x
    return pad_nhwc(x, *same_pads(x.shape[1], x.shape[2], out_h, out_w,
                                  stride, kernel))


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product as int32, on any device.

    torch has no int32 matmul on CUDA, so the plain versions multiply in
    float64: integer operands give exact integer partial sums while they
    stay below 2^53, far above any accumulator here (|code| <= 255,
    |weight| <= 127, K < 2^38 terms), so every summation order gives the
    same integers as the reference's int32 matmul."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def direct_conv_acc(x_pad: torch.Tensor, w2d: torch.Tensor, *, kernel: int,
                    stride: int, out_h: int, out_w: int) -> torch.Tensor:
    """The conv accumulator as shifted-window tap sums — no patch matrix.

    ``x_pad`` (N, HP, WP, C) is already padded. The taps accumulate exactly,
    in float64 as ``int_matmul`` does. Returns (N, out_h, out_w, F) int32."""
    c = x_pad.shape[3]
    rh = (out_h - 1) * stride + 1
    rw = (out_w - 1) * stride + 1
    x = x_pad.to(torch.float64)
    acc = None
    for kh in range(kernel):
        for kw in range(kernel):
            xs = x[:, kh:kh + rh:stride, kw:kw + rw:stride, :]
            tap = (kh * kernel + kw) * c
            t = xs @ w2d[tap:tap + c, :].to(torch.float64)
            acc = t if acc is None else acc + t
    return acc.to(torch.int32)


def conv_threshold_ref(x_pad: torch.Tensor, w2d: torch.Tensor,
                       thresholds: torch.Tensor, *, kernel: int, stride: int,
                       out_h: int, out_w: int) -> torch.Tensor:
    """Plain version of the fused stage on padded codes: the exact tap
    accumulator, then out[..., f] = #{s : acc[..., f] >= T[f, s]}."""
    from repro_torch.kernels.ref import multi_threshold_ref

    acc = direct_conv_acc(x_pad, w2d, kernel=kernel, stride=stride,
                          out_h=out_h, out_w=out_w)
    return multi_threshold_ref(acc, thresholds)
