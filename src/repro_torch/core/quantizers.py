"""The deployment subset of ``repro.core.quantizers`` on torch tensors.

Streamlining and the QIR interpreter need three pieces: ``quantize_po2``
(snap a scale to a power of two), ``minmax_scale`` (max-abs scale) and
``IntQuantizer`` (its forward and ``quantize_int``). Every step keeps the
reference's float32 arithmetic and operation order, because the threshold
banks built from these scales must equal the reference's bit for bit. The
straight-through gradients of the QAT side come with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def quantize_po2(scale, lo=2.0 ** -24, hi=2.0 ** 24) -> torch.Tensor:
    """Snap a positive scale to the nearest power of two (float32)."""
    scale = torch.clamp(_f32(scale), lo, hi)
    return torch.pow(2.0, torch.round(torch.log2(scale)))


def minmax_scale(x: torch.Tensor, qmax, axis=None, keepdims=True,
                 eps=1e-8) -> torch.Tensor:
    """Symmetric per-tensor / per-channel scale from the max-abs statistic."""
    a = torch.abs(x)
    if axis is None:
        amax = torch.amax(a)
        if keepdims:
            amax = amax.reshape((1,) * x.ndim)
    else:
        amax = torch.amax(a, dim=axis, keepdim=keepdims)
    return torch.clamp(amax, min=eps) / qmax


@dataclasses.dataclass(frozen=True)
class IntQuantizer:
    """Integer quantizer with a runtime (min-max) scale.

    ``q(x) = clip(round(x / s), qmin, qmax) * s`` with s per-tensor or
    per-channel (``axis``). ``po2`` snaps the scale to a power of two.
    """

    bits: int = 8
    signed: bool = True
    axis: Optional[int] = None
    po2: bool = False
    narrow: bool = False  # symmetric range [-qmax, qmax] (weights)

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.signed else 2 ** self.bits - 1

    @property
    def qmin(self) -> int:
        if not self.signed:
            return 0
        return -self.qmax if self.narrow else -(2 ** (self.bits - 1))

    def scale(self, x: torch.Tensor) -> torch.Tensor:
        s = minmax_scale(x, self.qmax, axis=self.axis, keepdims=True)
        if self.po2:
            s = quantize_po2(s)
        return s

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale(x)
        q = torch.clamp(torch.round(x / s), float(self.qmin), float(self.qmax))
        return q * s

    def quantize_int(self, x: torch.Tensor):
        """Return (int codes, scale) — the deployment-side representation."""
        s = self.scale(x)
        q = torch.clamp(torch.round(x / s), self.qmin, self.qmax)
        if self.bits <= 8:
            # JAX's float -> int8 cast saturates (unsigned 8-bit codes above
            # 127 become 127); torch's wraps, so clamp first
            return torch.clamp(q, -128, 127).to(torch.int8), s
        return q.to(torch.int32), s
