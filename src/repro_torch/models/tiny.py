"""The paper's two conv models as numpy-only descriptions.

The port of ``ICModel`` and ``CNVModel`` from ``repro.models.tiny`` (Table 1
of the paper): the same fields and defaults, ``conv_layers()`` (what
``core.qir.export_qcnn`` reads), ``feature_hw()`` / ``n_weights()`` and
``cost()`` (through ``core.bops``). ``init_numpy(seed)`` draws parameter
dicts with the structure, shapes and Glorot-uniform ranges of the
reference's ``init`` from ``numpy.random.default_rng``, so a full-width
graph needs no JAX. The QAT side (``init`` on a JAX key, ``apply`` and the
quantized layers) comes with the QAT slice.

  IC  (hls4ml) : 8-bit CNN, 32x32x3, filters 32-4-32-32-4   -> ``ICModel``
  IC  (FINN)   : CNV-W1A1, 1,542,848 weights                 -> ``CNVModel``
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.bops import ModelCost, conv_cost, dense_cost


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One conv layer as the exporter reads it (the reference's ``QConv2D``
    without its quantizers)."""

    in_ch: int
    out_ch: int
    kernel: int = 3
    stride: int = 1
    padding: str = "SAME"
    weight_bits: int = 8
    act_bits: int = 8


def _glorot(rng, shape, fan_in: int, fan_out: int) -> np.ndarray:
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return rng.uniform(-limit, limit, shape).astype(np.float32)


def _init_conv(rng, ld: ConvLayer) -> Dict[str, np.ndarray]:
    """``QConv2D.init``: (k, k, in, out) Glorot-uniform weights, zero bias."""
    k = ld.kernel
    return {"w": _glorot(rng, (k, k, ld.in_ch, ld.out_ch),
                         ld.in_ch * k * k, ld.out_ch * k * k),
            "b": np.zeros((ld.out_ch,), np.float32)}


def _init_dense(rng, in_dim: int, out_dim: int) -> Dict[str, np.ndarray]:
    """``qlayers._init_dense``: (in, out) Glorot-uniform weights, zero bias."""
    return {"w": _glorot(rng, (in_dim, out_dim), in_dim, out_dim),
            "b": np.zeros((out_dim,), np.float32)}


@dataclasses.dataclass(frozen=True)
class ICModel:
    """Paper §3.1.1 v0.7 model: 5 convs (32,4,32,32,4 filters; kernels
    1,4,4,4,4; strides 1,1,1,4,1; SAME) + dense head; 8-bit."""

    filters: Tuple[int, ...] = (32, 4, 32, 32, 4)
    kernels: Tuple[int, ...] = (1, 4, 4, 4, 4)
    strides: Tuple[int, ...] = (1, 1, 1, 4, 1)
    n_classes: int = 10
    weight_bits: int = 8
    act_bits: int = 8
    in_hw: int = 32
    in_ch: int = 3

    def conv_layers(self) -> List[ConvLayer]:
        convs, cin = [], self.in_ch
        for f, k, s in zip(self.filters, self.kernels, self.strides):
            convs.append(ConvLayer(cin, f, kernel=k, stride=s,
                                   padding="SAME",
                                   weight_bits=self.weight_bits,
                                   act_bits=self.act_bits))
            cin = f
        return convs

    def feature_hw(self) -> int:
        hw = self.in_hw
        for s in self.strides:
            hw = -(-hw // s)  # ceil for SAME padding
        return hw

    def init_numpy(self, seed: int) -> Dict:
        rng = np.random.default_rng(seed)
        convs = [_init_conv(rng, ld) for ld in self.conv_layers()]
        flat = self.feature_hw() ** 2 * self.filters[-1]
        return {"convs": convs,
                "head": _init_dense(rng, flat, self.n_classes)}

    def cost(self) -> ModelCost:
        ls, cin, hw = [], self.in_ch, self.in_hw
        for i, (f, k, s) in enumerate(zip(self.filters, self.kernels,
                                          self.strides)):
            hw = -(-hw // s)
            ls.append(conv_cost(f"conv{i}", cin, f, k, hw, hw,
                                self.act_bits, self.weight_bits))
            cin = f
        flat = hw * hw * self.filters[-1]
        ls.append(dense_cost("head", flat, self.n_classes,
                             self.act_bits, self.weight_bits))
        return ModelCost(ls)


@dataclasses.dataclass(frozen=True)
class CNVModel:
    """CNV-W1A1 (Umuroglu et al. 2017): 3x3 VALID convs 64,64 / 128,128 /
    256,256 with a 2x2 maxpool after the first two blocks, then FC 512,
    512, 10. Binary weights and activations except the 8-bit input layer;
    1,542,848 weights (paper Table 1)."""

    channels: Tuple[int, ...] = (64, 64, 128, 128, 256, 256)
    fc: Tuple[int, ...] = (512, 512)
    n_classes: int = 10
    weight_bits: int = 1
    act_bits: int = 1
    in_hw: int = 32
    in_ch: int = 3
    pool_after: Tuple[int, ...] = (1, 3)  # 2x2 maxpool after these convs

    def conv_layers(self) -> List[ConvLayer]:
        convs, cin = [], self.in_ch
        for i, ch in enumerate(self.channels):
            # the input layer consumes 8-bit images; the rest are binary
            convs.append(ConvLayer(cin, ch, kernel=3, stride=1,
                                   padding="VALID",
                                   weight_bits=self.weight_bits,
                                   act_bits=8 if i == 0 else self.act_bits))
            cin = ch
        return convs

    def init_numpy(self, seed: int) -> Dict:
        rng = np.random.default_rng(seed)
        convs = [_init_conv(rng, ld) for ld in self.conv_layers()]
        dims = [self.channels[-1], *self.fc, self.n_classes]
        fcs = [_init_dense(rng, dims[i], dims[i + 1])
               for i in range(len(dims) - 1)]
        return {"convs": convs, "fcs": fcs}

    def n_weights(self) -> int:
        total, cin = 0, self.in_ch
        for ch in self.channels:
            total += 3 * 3 * cin * ch
            cin = ch
        total += self.channels[-1] * self.fc[0]
        total += self.fc[0] * self.fc[1]
        total += self.fc[1] * self.n_classes
        return total

    def cost(self) -> ModelCost:
        ls, cin, hw = [], self.in_ch, self.in_hw
        for i, ch in enumerate(self.channels):
            hw = hw - 2  # VALID 3x3
            ls.append(conv_cost(f"conv{i}", cin, ch, 3, hw, hw,
                                8 if i == 0 else 1, 1, bias=False))
            if i in self.pool_after:
                hw //= 2
            cin = ch
        dims = [self.channels[-1], *self.fc, self.n_classes]
        for i in range(len(dims) - 1):
            ls.append(dense_cost(f"fc{i}", dims[i], dims[i + 1], 1, 1,
                                 bias=False))
        return ModelCost(ls)
