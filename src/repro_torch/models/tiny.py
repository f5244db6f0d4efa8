"""The paper's four MLPerf Tiny submission models, with QAT, on torch.

The port of ``repro.models.tiny`` (Table 1 of the paper):

  IC  (hls4ml) : 8-bit CNN, 32x32x3, filters 32-4-32-32-4   -> ``ICModel``
  IC  (FINN)   : CNV-W1A1, 1,542,848 weights                 -> ``CNVModel``
  AD  (hls4ml) : 128-72-72-8-72-72-128 autoencoder, 8-bit    -> ``ADAutoencoder``
  KWS (FINN)   : 490-256-256-256-12 MLP, 3-bit               -> ``KWSMLP``

Each model is a frozen description with the reference's fields and
defaults, ``cost()`` (through ``core.bops``) and its parameter counts.
``init(generator, device)`` builds a ``TinyNet``, the ``nn.Module`` that
holds the quantized layers (``core.qlayers``) in the reference's
parameter structure; ``apply(net, x, train)`` (and ``net(x, train)``) is
the reference's QAT forward. In train mode the BN layers update their
running statistics in place where the reference returns new parameters.
``net.from_numpy(params)`` / ``net.to_numpy()`` carry the reference's
parameter dicts across. ``ICModel`` and ``CNVModel`` also keep
``conv_layers()`` and ``init_numpy(seed)`` (numpy-seeded parameter dicts
with the reference's shapes and Glorot-uniform ranges), which the
exporter (``core.qir.export_qcnn``) and the full-width bench graphs read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.bops import ModelCost, conv_cost, dense_cost
from repro_torch.core.qir import full_fp32, max_pool_nhwc
from repro_torch.core.qlayers import QConv2D, QDense, QDenseBatchNorm
from repro_torch.core.quantizers import ste_sign


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One conv layer as the exporter reads it: the fields of the
    reference's ``QConv2D``; ``build`` makes the quantized layer."""

    in_ch: int
    out_ch: int
    kernel: int = 3
    stride: int = 1
    padding: str = "SAME"
    weight_bits: int = 8
    act_bits: int = 8
    weight_kind: str = "int"
    relu: bool = False
    use_bias: bool = True

    def build(self, generator: Optional[torch.Generator] = None,
              device=None) -> QConv2D:
        return QConv2D(**dataclasses.asdict(self), generator=generator,
                       device=device)


class TinyNet(nn.Module):
    """The parameters of one tiny model in the reference's structure —
    ``hidden`` + ``head`` (KWS, AD), ``convs`` + ``head`` (IC), ``convs``
    + ``fcs`` (CNV) — and its QAT forward (``model.apply``)."""

    def __init__(self, model, **parts):
        super().__init__()
        self.model = model
        for name, part in parts.items():
            setattr(self, name, nn.ModuleList(part) if isinstance(part, list)
                    else part)
        self._parts = tuple(parts)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        return self.model.apply(self, x, train=train)

    def from_numpy(self, params: Dict) -> "TinyNet":
        """Load a reference parameter dict (numpy or JAX arrays)."""
        for name in self._parts:
            part = getattr(self, name)
            if isinstance(part, nn.ModuleList):
                for layer, p in zip(part, params[name]):
                    layer.from_numpy(p)
            else:
                part.from_numpy(params[name])
        return self

    def to_numpy(self) -> Dict:
        out = {}
        for name in self._parts:
            part = getattr(self, name)
            out[name] = ([layer.to_numpy() for layer in part]
                         if isinstance(part, nn.ModuleList)
                         else part.to_numpy())
        return out


def _run_hidden(hidden, h, train):
    for layer in hidden:
        h = layer(h, train=train)
    return h


@dataclasses.dataclass(frozen=True)
class ADAutoencoder:
    """128 -> [72 72] -> 8 -> [72 72] -> 128; QDenseBatchNorm + ReLU hidden
    stages (paper §3.3: 5 hidden layers, width 72, 128-dim input)."""

    in_dim: int = 128
    width: int = 72
    bottleneck: int = 8
    weight_bits: int = 8
    act_bits: int = 8
    use_bn: bool = True

    @property
    def dims(self) -> List[int]:
        return [self.in_dim, self.width, self.width, self.bottleneck,
                self.width, self.width, self.in_dim]

    def layers(self, generator: Optional[torch.Generator] = None,
               device=None):
        """(hidden layers, head), freshly initialised."""
        ds, hidden = self.dims, []
        for i in range(len(ds) - 2):
            if self.use_bn:
                hidden.append(QDenseBatchNorm(
                    ds[i], ds[i + 1], weight_bits=self.weight_bits,
                    act_bits=self.act_bits, generator=generator,
                    device=device))
            else:
                hidden.append(QDense(
                    ds[i], ds[i + 1], weight_bits=self.weight_bits,
                    act_bits=self.act_bits, relu=True, generator=generator,
                    device=device))
        head = QDense(ds[-2], ds[-1], weight_bits=self.weight_bits,
                      act_bits=32, relu=False, generator=generator,
                      device=device)
        return hidden, head

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> TinyNet:
        hidden, head = self.layers(generator, device)
        return TinyNet(self, hidden=hidden, head=head)

    def apply(self, net: TinyNet, x: torch.Tensor,
              train: bool = True) -> torch.Tensor:
        """The reconstruction; BN statistics update in train mode."""
        with full_fp32():
            return net.head(_run_hidden(net.hidden, x, train), train=train)

    def anomaly_score(self, net: TinyNet, x: torch.Tensor) -> torch.Tensor:
        recon = self.apply(net, x, train=False)
        return torch.mean(torch.square(recon - x), dim=-1)

    def cost(self) -> ModelCost:
        ds = self.dims
        return ModelCost([dense_cost(f"fc{i}", ds[i], ds[i + 1],
                                     self.act_bits, self.weight_bits)
                          for i in range(len(ds) - 1)])

    def n_params(self) -> int:
        hidden, head = self.layers(device="meta")
        return sum(l.n_params() for l in hidden) + head.n_params()


@dataclasses.dataclass(frozen=True)
class KWSMLP:
    """490 (10 MFCC x 49 frames) -> 256 x3 (BN+ReLU) -> 12; 3-bit weights
    and activations (paper §3.4). 259,584 weights."""

    in_dim: int = 490
    width: int = 256
    n_classes: int = 12
    weight_bits: int = 3
    act_bits: int = 3

    @property
    def dims(self) -> List[int]:
        return [self.in_dim, self.width, self.width, self.width,
                self.n_classes]

    def layers(self, generator: Optional[torch.Generator] = None,
               device=None):
        """(hidden layers, head), freshly initialised."""
        ds = self.dims
        hidden = [QDenseBatchNorm(ds[i], ds[i + 1],
                                  weight_bits=self.weight_bits,
                                  act_bits=self.act_bits,
                                  generator=generator, device=device)
                  for i in range(3)]
        head = QDense(self.width, self.n_classes,
                      weight_bits=self.weight_bits, act_bits=32, relu=False,
                      generator=generator, device=device)
        return hidden, head

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> TinyNet:
        hidden, head = self.layers(generator, device)
        return TinyNet(self, hidden=hidden, head=head)

    def apply(self, net: TinyNet, x: torch.Tensor,
              train: bool = True) -> torch.Tensor:
        """The logits; BN statistics update in train mode."""
        with full_fp32():
            return net.head(_run_hidden(net.hidden, x, train), train=train)

    def cost(self) -> ModelCost:
        ds = self.dims
        return ModelCost([dense_cost(f"fc{i}", ds[i], ds[i + 1],
                                     self.act_bits, self.weight_bits,
                                     bias=False) for i in range(4)])

    def n_weights(self) -> int:
        ds = self.dims
        return sum(ds[i] * ds[i + 1] for i in range(4))


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
                                   act_bits=self.act_bits, relu=True))
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

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> TinyNet:
        convs = [ld.build(generator, device) for ld in self.conv_layers()]
        flat = self.feature_hw() ** 2 * self.filters[-1]
        head = QDense(flat, self.n_classes, weight_bits=self.weight_bits,
                      act_bits=32, relu=False, generator=generator,
                      device=device)
        return TinyNet(self, convs=convs, head=head)

    def apply(self, net: TinyNet, x: torch.Tensor,
              train: bool = True) -> torch.Tensor:
        """NHWC images -> logits (reference ``tiny.py:194-203``)."""
        with full_fp32():
            h = _run_hidden(net.convs, x, train)
            return net.head(h.reshape(h.shape[0], -1), train=train)

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
                                   act_bits=8 if i == 0 else self.act_bits,
                                   weight_kind="binary", use_bias=False))
            cin = ch
        return convs

    def init_numpy(self, seed: int) -> Dict:
        rng = np.random.default_rng(seed)
        convs = [_init_conv(rng, ld) for ld in self.conv_layers()]
        dims = [self.channels[-1], *self.fc, self.n_classes]
        fcs = [_init_dense(rng, dims[i], dims[i + 1])
               for i in range(len(dims) - 1)]
        return {"convs": convs, "fcs": fcs}

    def init(self, generator: Optional[torch.Generator] = None,
             device=None) -> TinyNet:
        convs = [ld.build(generator, device) for ld in self.conv_layers()]
        dims = [self.channels[-1], *self.fc, self.n_classes]
        # the forward's FC layers: binary weights, no activation quantizer
        # (the reference's ``apply`` builds them with act_bits=32 and signs
        # the hidden outputs itself)
        fcs = [QDense(dims[i], dims[i + 1], weight_bits=self.weight_bits,
                      act_bits=32, weight_kind="binary", use_bias=False,
                      generator=generator, device=device)
               for i in range(len(dims) - 1)]
        return TinyNet(self, convs=convs, fcs=fcs)

    def apply(self, net: TinyNet, x: torch.Tensor,
              train: bool = True) -> torch.Tensor:
        """NHWC images -> logits (reference ``tiny.py:264-283``): each conv
        output signed, 2x2 max pools after ``pool_after``, signed hidden
        FCs. The convs' 1-bit weights are NaN (``core.qlayers``), so every
        conv output signs to -1 and the logits do not depend on x, as in
        the reference."""
        with full_fp32():
            h = x
            for i, conv in enumerate(net.convs):
                h = ste_sign(conv(h, train=train))
                if i in self.pool_after:
                    h = max_pool_nhwc(h, 2, 2, "VALID")
            h = h.reshape(h.shape[0], -1)
            for i, fc in enumerate(net.fcs):
                h = fc(h, train=train)
                if i < len(net.fcs) - 1:
                    h = ste_sign(h)
            return h

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
