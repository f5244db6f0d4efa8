"""Arbitrary-precision quantizers with straight-through estimators, on
torch tensors.

The port of ``repro.core.quantizers`` (paper C1: QAT at 1-12 bits). Every
quantizer is a function ``q(x) -> x_hat`` whose backward pass is the
straight-through estimator. The reference's three ``jax.custom_vjp``
primitives become ``torch.autograd.Function``s with the same forward and
the same gradient:

  * ``ste_round`` — round half to even, identity gradient;
  * ``ste_clip``  — clip, gradient masked to ``lo <= x <= hi``;
  * ``ste_sign``  — ``x >= 0 -> 1`` else -1, gradient masked to
    ``|x| <= 1`` (BinaryNet's hard-tanh STE).

Quantizers: ``FixedPointQuantizer``, ``IntQuantizer`` (its scale carries
no gradient, as ``stop_gradient`` in the reference), ``BinaryQuantizer``,
``TernaryQuantizer``; ``make_quantizer`` and ``fake_quant_act``. The
deployment helpers ``quantize_po2``, ``minmax_scale`` and
``IntQuantizer.quantize_int`` keep the reference's float32 arithmetic and
operation order, because the threshold banks built from these scales must
equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# straight-through rounding primitives
# ---------------------------------------------------------------------------

class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)           # half to even, as jnp.round

    @staticmethod
    def backward(ctx, g):
        return g


class _SteClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        mask = ((x >= ctx.lo) & (x <= ctx.hi)).to(g.dtype)
        return g * mask, None, None


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (torch.abs(x) <= 1.0).to(g.dtype)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with an identity gradient."""
    return _SteRound.apply(x)


def ste_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip whose gradient is 1 inside [lo, hi] and 0 outside."""
    return _SteClip.apply(x, float(lo), float(hi))


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Bipolar sign (0 -> +1) with the clipped-identity gradient."""
    return _SteSign.apply(x)


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
class FixedPointQuantizer:
    """QKeras ``quantized_bits(bits, integer, keep_negative=1)``.

    Value grid: step = 2^(integer - (bits-1)) for signed numbers; the
    representable range is [-2^integer, 2^integer - step]."""

    bits: int = 8
    integer: int = 2
    signed: bool = True

    @property
    def step(self) -> float:
        frac_bits = self.bits - self.integer - (1 if self.signed else 0)
        return 2.0 ** (-frac_bits)

    @property
    def qmin(self) -> float:
        return -(2.0 ** self.integer) if self.signed else 0.0

    @property
    def qmax(self) -> float:
        return 2.0 ** self.integer - self.step

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = ste_clip(x, self.qmin, self.qmax)
        return ste_round(x / self.step) * self.step

    def int_repr(self, x: torch.Tensor) -> torch.Tensor:
        """Integer code for a (clipped) value."""
        return torch.round(torch.clamp(x, self.qmin, self.qmax)
                           / self.step).to(torch.int32)


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
        """The min-max scale, detached (``stop_gradient`` in the
        reference)."""
        s = minmax_scale(x.detach(), self.qmax, axis=self.axis, keepdims=True)
        if self.po2:
            s = quantize_po2(s)
        return s

    def __call__(self, x: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The fake-quantized ``x``; ``scale`` (None: ``self.scale(x)``)
        is given where x is a block of the tensor whose min-max sets
        it."""
        s = self.scale(x) if scale is None else scale
        q = ste_round(x / s)
        q = ste_clip(q, float(self.qmin), float(self.qmax))
        return q * s

    def quantize_int(self, x: torch.Tensor,
                     scale: Optional[torch.Tensor] = None):
        """Return (int codes, scale) — the deployment-side representation;
        ``scale`` (None: ``self.scale(x)``) is given where x is a block of
        the tensor whose min-max sets it."""
        s = self.scale(x) if scale is None else scale
        q = torch.clamp(torch.round(x / s), self.qmin, self.qmax)
        if self.bits <= 8:
            # JAX's float -> int8 cast saturates (unsigned 8-bit codes above
            # 127 become 127); torch's wraps, so clamp first
            return torch.clamp(q, -128, 127).to(torch.int8), s
        return q.to(torch.int32), s


@dataclasses.dataclass(frozen=True)
class BinaryQuantizer:
    """Bipolar {-scale, +scale} quantizer (CNV-W1A1)."""

    bits: int = 1
    scale_value: float = 1.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return ste_sign(x) * self.scale_value


@dataclasses.dataclass(frozen=True)
class TernaryQuantizer:
    """{-1, 0, +1} with a dead zone of +-``threshold``; the gradient is
    the identity's inside [-1, 1]."""

    bits: int = 2
    threshold: float = 0.05

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        pos = (x > self.threshold).to(x.dtype)
        neg = (x < -self.threshold).to(x.dtype)
        hard = pos - neg
        c = ste_clip(x, -1.0, 1.0)
        return hard + (c - c.detach())


def make_quantizer(bits: int, kind: str = "int", **kw):
    """Factory keyed the way configs express precision: None at 32 bits
    or ``kind="none"``; binary at 1 bit."""
    if bits >= 32 or kind == "none":
        return None
    if bits == 1 or kind == "binary":
        return BinaryQuantizer()
    if kind == "ternary":
        return TernaryQuantizer()
    if kind == "fixed":
        return FixedPointQuantizer(bits=bits, **kw)
    return IntQuantizer(bits=bits, **kw)


def fake_quant_act(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-tensor symmetric activation fake-quant (QAT for LM stacks)."""
    if bits >= 16:
        return x
    return IntQuantizer(bits=bits, signed=True)(x)
