"""Quantization-aware layers (QDense, QDenseBatchNorm, QConv2D) as
``nn.Module``s.

The port of ``repro.core.qlayers``. The reference keeps parameters in
plain dicts beside frozen layer descriptions (``init`` / ``apply``); here
each layer owns its parameters, named after the reference's dict keys
(``w``, ``b`` and, for ``QDenseBatchNorm``, ``gamma``, ``beta``, ``mu``,
``sigma2``). ``from_numpy(params)`` loads a reference parameter dict and
``to_numpy()`` returns one, so both packages can run the same weights.

  * ``QDense``          — FC layer with weight / activation quantizers.
  * ``QDenseBatchNorm`` — the paper's §3.3.1 layer: BN folded into the FC
                          kernel during training (Eqs. 3-4),
                          k = v * k_FC, b = v * (b_FC - mu) + beta,
                          v = gamma / sqrt(sigma^2 + eps).
  * ``QConv2D``         — NHWC conv (HWIO weights) with the same hooks.

What the reference does and this port keeps:
  * ``mu`` and ``sigma2`` are parameters, not buffers: the reference's
    trainer differentiates every leaf, and in eval mode the fold reads
    them, so its optimizer updates them.
  * Train-mode BN folds with the batch's mean and population variance and
    updates the running statistics without gradient (in place here; the
    reference returns them as new parameters).
  * ``QConv2D`` quantizes its weights with the narrow ``IntQuantizer``
    arithmetic whatever ``weight_kind`` says; at 1 bit its ``qmax`` is 0,
    so the scale is inf and the weights NaN (the reference's behaviour,
    ``repro/core/qlayers.py:189-201``).

Init takes an explicit ``torch.Generator``: Glorot-uniform weights, zero
biases, the BN statistics at the identity. JAX's PRNG cannot be
reproduced, so tests carry the reference's parameters across instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.qir import conv2d_nhwc
from repro_torch.core.quantizers import (IntQuantizer, make_quantizer,
                                         ste_clip, ste_round)

def _glorot(shape, fan_in: int, fan_out: int,
            generator: Optional[torch.Generator], device) -> torch.Tensor:
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return u * (2 * limit) - limit


class _QLayer(nn.Module):
    """Parameter exchange with the reference's dicts."""

    def from_numpy(self, params: Dict[str, np.ndarray]) -> "_QLayer":
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                p.copy_(torch.as_tensor(np.array(params[name]),
                                        dtype=p.dtype))
        return self

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {name: p.detach().cpu().numpy()
                for name, p in self.named_parameters(recurse=False)}

    def n_params(self) -> int:
        raise NotImplementedError


class QDense(_QLayer):
    """FC layer with quantizer hooks and an optional merged ReLU."""

    def __init__(self, in_dim: int, out_dim: int, weight_bits: int = 8,
                 act_bits: int = 8, weight_kind: str = "int",
                 act_kind: str = "int", use_bias: bool = True,
                 relu: bool = False, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight_bits, self.act_bits = weight_bits, act_bits
        self.weight_kind, self.act_kind = weight_kind, act_kind
        self.use_bias, self.relu = use_bias, relu
        self.w = nn.Parameter(_glorot((in_dim, out_dim), in_dim, out_dim,
                                      generator, device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))

    @property
    def wq(self):
        return make_quantizer(self.weight_bits, self.weight_kind, axis=0)

    @property
    def aq(self):
        return make_quantizer(self.act_bits, self.act_kind)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        w = self.w
        if self.wq is not None:
            w = self.wq(w)
        y = x @ w
        if self.use_bias:
            y = y + self.b
        if self.relu:
            y = torch.relu(y)
        if self.aq is not None:
            y = self.aq(y)
        return y

    def n_params(self) -> int:
        return self.in_dim * self.out_dim + (self.out_dim if self.use_bias
                                             else 0)


class QDenseBatchNorm(_QLayer):
    """FC + BN folded during the forward pass (paper Eqs. 3-4): every
    forward quantizes the folded kernel, so train-time arithmetic matches
    the deployed integer layer."""

    def __init__(self, in_dim: int, out_dim: int, weight_bits: int = 8,
                 act_bits: int = 8, relu: bool = True,
                 momentum: float = 0.99, eps: float = 1e-3, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight_bits, self.act_bits = weight_bits, act_bits
        self.relu, self.momentum, self.eps = relu, momentum, eps
        self.w = nn.Parameter(_glorot((in_dim, out_dim), in_dim, out_dim,
                                      generator, device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))
        self.gamma = nn.Parameter(torch.ones(out_dim, device=device))
        self.beta = nn.Parameter(torch.zeros(out_dim, device=device))
        self.mu = nn.Parameter(torch.zeros(out_dim, device=device))
        self.sigma2 = nn.Parameter(torch.ones(out_dim, device=device))

    @property
    def wq(self):
        return make_quantizer(self.weight_bits, "int", axis=0)

    @property
    def aq(self):
        return make_quantizer(self.act_bits, "int")

    def fold(self):
        """Eqs. 3-4 with the running statistics: (k_folded, b_folded)."""
        v = self.gamma / torch.sqrt(self.sigma2 + self.eps)
        return self.w * v[None, :], v * (self.b - self.mu) + self.beta

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """In train mode: fold with the batch's statistics and update the
        running ``mu`` / ``sigma2`` in place (without gradient)."""
        if train:
            y_fc = x @ self.w + self.b
            red = tuple(range(y_fc.dim() - 1))
            mu_b = torch.mean(y_fc, dim=red)
            var_b = torch.var(y_fc, dim=red, unbiased=False)
            m = self.momentum
            with torch.no_grad():
                self.mu.copy_(m * self.mu + (1 - m) * mu_b)
                self.sigma2.copy_(m * self.sigma2 + (1 - m) * var_b)
            v = self.gamma / torch.sqrt(var_b + self.eps)
            k_folded = self.w * v[None, :]
            b_folded = v * (self.b - mu_b) + self.beta
        else:
            k_folded, b_folded = self.fold()
        if self.wq is not None:
            k_folded = self.wq(k_folded)
        y = x @ k_folded + b_folded
        if self.relu:
            y = torch.relu(y)
        if self.aq is not None:
            y = self.aq(y)
        return y

    def n_params(self) -> int:
        return self.in_dim * self.out_dim + 5 * self.out_dim


class QConv2D(_QLayer):
    """NHWC conv with HWIO weights, quantizer hooks and an optional merged
    ReLU; SAME pads as XLA does (low side floor(pad / 2), so IC's 4x4
    stride-4 convs pad unevenly)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding: str = "SAME", weight_bits: int = 8,
                 act_bits: int = 8, weight_kind: str = "int",
                 relu: bool = False, use_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.weight_bits, self.act_bits = weight_bits, act_bits
        self.weight_kind, self.relu, self.use_bias = (weight_kind, relu,
                                                      use_bias)
        k = kernel
        self.w = nn.Parameter(_glorot((k, k, in_ch, out_ch), in_ch * k * k,
                                      out_ch * k * k, generator, device))
        self.b = nn.Parameter(torch.zeros(out_ch, device=device))

    @property
    def wq(self):
        return make_quantizer(self.weight_bits, self.weight_kind,
                              axis=(0, 1, 2))

    @property
    def aq(self):
        return make_quantizer(self.act_bits, "int")

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        w = self.w
        if self.wq is not None:
            # per-output-channel scale over (kh, kw, cin), narrow integer
            # grid whatever the kind (NaN at 1 bit, as in the reference)
            q = IntQuantizer(bits=self.weight_bits, signed=True, narrow=True)
            amax = torch.amax(torch.abs(w.detach()), dim=(0, 1, 2),
                              keepdim=True)
            s = torch.clamp(amax, min=1e-8) / q.qmax
            w = ste_clip(ste_round(w / s), float(q.qmin), float(q.qmax)) * s
        y = conv2d_nhwc(x, w, self.stride, self.padding)
        if self.use_bias:
            y = y + self.b
        if self.relu:
            y = torch.relu(y)
        if self.aq is not None:
            y = self.aq(y)
        return y

    def n_params(self) -> int:
        k = self.kernel
        return k * k * self.in_ch * self.out_ch + (self.out_ch if
                                                   self.use_bias else 0)
