"""Streamlining on torch: fold float bookkeeping into integer thresholds.

The port of ``repro.core.streamline`` (paper C2, after Umuroglu & Jahre
2017). Every uniformly quantized float chain

    acc(int32) --*s_w*s_a--> float --BN--> float --ReLU--> float --quant--> q

is monotonic in the integer accumulator, so it collapses to a bank of
integer thresholds per output channel: q = sum_i [acc >= T[c, i]].

Banks and scales are built in float32 with the reference's operation
order, so they equal the reference's bit for bit; the float -> int32 cast
of a bank saturates as JAX's does (``_saturating_int32``).
``streamline_mlp`` turns a trained QAT stack into a ``StreamlinedMLP``
(integer threshold stages and a float head); ``constant_fold`` folds
Quant nodes of initializers in a QIR graph.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantizers import IntQuantizer, quantize_po2

_INT32 = torch.iinfo(torch.int32)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _saturating_int32(t: torch.Tensor) -> torch.Tensor:
    """float -> int32 as ``jnp.astype(jnp.int32)`` does it: out-of-range
    values saturate to the int32 limits and NaN becomes 0. torch's plain
    ``.to(torch.int32)`` gives INT32_MIN for all of them, which would turn
    the unreachable bank of an all-zero weight column (s_w = 1e-8/qmax)
    into an always-reached one. Clamped in float64, where both limits are
    exact."""
    t = torch.nan_to_num(t.to(torch.float64), nan=0.0)
    return torch.clamp(t, _INT32.min, _INT32.max).to(torch.int32)


def quant_act_ref(y: torch.Tensor, s_out: float, qmax: int) -> torch.Tensor:
    """Unsigned activation quant with round-half-up: clip(floor(y/s+0.5),0,qmax)."""
    return torch.clamp(torch.floor(y / s_out + 0.5), 0, qmax).to(torch.int32)


@dataclasses.dataclass
class ThresholdDense:
    """A streamlined (deployment-form) matmul stage.

    y_int = multi_threshold(x_int @ w_int, thresholds) in [0, 2^act_bits - 1];
    the float value of the output is y_int * out_scale. Convolutions lower
    to the same form with w_int holding the (kh*kw*cin, cout) im2col matrix.
    """

    w_int: torch.Tensor       # (in, out) int8 codes
    thresholds: torch.Tensor  # (out, n_steps) int32, sorted along steps
    out_scale: float          # po2 scalar
    act_bits: int
    weight_bits: int = 8

    @property
    def n_steps(self) -> int:
        return 2 ** self.act_bits - 1

    def to(self, device) -> "ThresholdDense":
        return dataclasses.replace(self, w_int=self.w_int.to(device),
                                   thresholds=self.thresholds.to(device))


def multi_threshold(acc: torch.Tensor, thresholds: torch.Tensor
                    ) -> torch.Tensor:
    """out[..., c] = #{i : acc[..., c] >= T[c, i]}.

    acc: (..., C) int32;  thresholds: (C, S) int32  ->  (..., C) int32."""
    return torch.sum(acc.unsqueeze(-1) >= thresholds, dim=-1,
                     dtype=torch.int32)


def multi_threshold_sorted(acc: torch.Tensor, thresholds: torch.Tensor
                           ) -> torch.Tensor:
    """``multi_threshold`` in O(log S) per element for *sorted* banks:
    #{i : acc >= T[c, i]} = searchsorted(T[c], acc, right=True), exact for
    duplicate thresholds too. A single-step bank is one compare."""
    if thresholds.shape[1] == 1:
        return (acc >= thresholds[:, 0]).to(torch.int32)
    c = acc.shape[-1]
    flat = acc.reshape(-1, c).transpose(0, 1).contiguous()      # (C, M)
    idx = torch.searchsorted(thresholds.contiguous(), flat, right=True)
    return idx.transpose(0, 1).reshape(acc.shape).to(torch.int32)


def _fold_affine(params, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_folded, b_folded) per paper Eqs. 3-4 for dense params with BN
    statistics; plain dense params fold to (w, b)."""
    if "gamma" in params:
        v = params["gamma"] / torch.sqrt(params["sigma2"] + eps)
        return (params["w"] * v[None, :],
                v * (params["b"] - params["mu"]) + params["beta"])
    return params["w"], params["b"]


def choose_act_scale(k2d, b, *, in_scale: float, act_bits: int,
                     in_qmax: Optional[int] = None) -> float:
    """Pick the po2 activation scale covering one stage's pre-act range.

    Reach: |acc| <= in_qmax * sum|w| per output channel, plus the bias.
    ``in_qmax`` defaults to 2^(act_bits-1) - 1, as in the reference."""
    qmax_out = 2 ** act_bits - 1
    if in_qmax is None:
        in_qmax = 2 ** (act_bits - 1) - 1
    k2d, b = _f32(k2d), _f32(b)
    reach = torch.amax(torch.sum(torch.abs(k2d), dim=0) * _f32(in_scale)
                       * _f32(in_qmax) + torch.abs(b))
    return float(quantize_po2(torch.clamp(reach, min=1e-8) / qmax_out))


def make_threshold_stage(
    w_int,
    s_w,
    b,
    *,
    in_scale: float,
    act_bits: int,
    s_out: Optional[float] = None,
    bipolar: bool = False,
    weight_bits: int = 8,
    in_qmax: Optional[int] = None,
) -> ThresholdDense:
    """Build the integer threshold bank for one already-quantized stage.

    ``w_int`` (in, out) integer weight codes with per-output-channel scale
    ``s_w``; the float pre-activation of channel c is
    y = acc * (s_w[c] * in_scale) + b[c].
      * half-up unsigned quant: boundary i is y >= (i - 0.5) * s_out, so
        acc >= ceil(((i - 0.5) * s_out - b) / denom);
      * ``bipolar``: one threshold at y >= 0, codes {0, 1}, out_scale 1.
    """
    s_w = _f32(s_w).reshape(-1)
    b = _f32(b).reshape(-1)
    denom = s_w * _f32(in_scale)
    if bipolar:
        t_float = (0.0 - b[:, None]) / denom[:, None]
        out_scale, act_bits = 1.0, 1
    else:
        if s_out is None:
            s_out = choose_act_scale(
                torch.abs(w_int.to(torch.float32)) * s_w[None, :], b,
                in_scale=in_scale, act_bits=act_bits, in_qmax=in_qmax)
        qmax_out = 2 ** act_bits - 1
        steps = torch.arange(1, qmax_out + 1, dtype=torch.float32)
        bound = (steps[None, :] - 0.5) * _f32(s_out)
        t_float = (bound - b[:, None]) / denom[:, None]
        out_scale = float(s_out)
    return ThresholdDense(
        w_int=w_int.to(torch.int8),
        thresholds=_saturating_int32(torch.ceil(t_float)).contiguous(),
        out_scale=out_scale,
        act_bits=act_bits,
        weight_bits=weight_bits,
    )


def streamline_dense(
    params,
    *,
    weight_bits: int,
    act_bits: int,
    in_scale: float,
    bn_eps: float = 1e-3,
    relu: bool = True,
    s_out: Optional[float] = None,
    in_qmax: Optional[int] = None,
) -> ThresholdDense:
    """Convert one (dense [+BN] + ReLU + act-quant) stage to thresholds.

    ``params`` holds float32 tensors; ``in_scale`` is the float value of
    one input integer step."""
    if not relu:
        raise NotImplementedError("streamlining currently targets ReLU stages")
    k_folded, b_folded = _fold_affine(params, bn_eps)
    wq = IntQuantizer(bits=weight_bits, signed=True, narrow=True, axis=0)
    w_int, s_w = wq.quantize_int(k_folded)          # s_w: (1, out)
    s_w = s_w.squeeze(0)
    if s_out is None:
        s_out = choose_act_scale(k_folded, b_folded, in_scale=in_scale,
                                 act_bits=act_bits, in_qmax=in_qmax)
    return make_threshold_stage(
        w_int, s_w, b_folded, in_scale=in_scale, act_bits=act_bits,
        s_out=s_out, weight_bits=weight_bits)


def _fold_affine_conv(params, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel BN fold for a (kh, kw, cin, cout) conv kernel."""
    if "gamma" in params:
        v = params["gamma"] / torch.sqrt(params["sigma2"] + eps)
        k = params["w"] * v[None, None, None, :]
        return k, v * (params["b"] - params["mu"]) + params["beta"]
    return params["w"], params["b"]


def streamline_conv(
    params,
    *,
    weight_bits: int,
    act_bits: int,
    in_scale: float,
    bn_eps: float = 1e-3,
    s_out: Optional[float] = None,
    in_qmax: Optional[int] = None,
    bipolar: bool = False,
) -> ThresholdDense:
    """Convert one (conv [+BN] + ReLU + act-quant) stage to thresholds; w_int
    is the (kh*kw*cin, cout) im2col matrix."""
    k_folded, b_folded = _fold_affine_conv(params, bn_eps)
    k2d = k_folded.reshape(-1, k_folded.shape[-1])
    wq = IntQuantizer(bits=weight_bits, signed=True, narrow=True, axis=0)
    w_int, s_w = wq.quantize_int(k2d)
    s_w = s_w.squeeze(0)
    if s_out is None and not bipolar:
        s_out = choose_act_scale(k2d, b_folded, in_scale=in_scale,
                                 act_bits=act_bits, in_qmax=in_qmax)
    return make_threshold_stage(
        w_int, s_w, b_folded, in_scale=in_scale, act_bits=act_bits,
        s_out=s_out, bipolar=bipolar, weight_bits=weight_bits)


def apply_threshold_dense(stage: ThresholdDense, x_int: torch.Tensor
                          ) -> torch.Tensor:
    """Run one streamlined stage on integer inputs (exact integer matmul)."""
    from repro_torch.kernels.ref import int_matmul

    return multi_threshold(int_matmul(x_int, stage.w_int), stage.thresholds)


def float_ref_dense(params, x, *, weight_bits, act_bits, s_out, bn_eps=1e-3):
    """The float-graph reference for one stage (fold -> quant w -> relu -> quant)."""
    k_folded, b_folded = _fold_affine(params, bn_eps)
    wq = IntQuantizer(bits=weight_bits, signed=True, narrow=True, axis=0)
    w_int, s_w = wq.quantize_int(k_folded)
    w_hat = w_int.to(torch.float32) * s_w
    y = torch.relu(x @ w_hat + b_folded)
    return quant_act_ref(y, s_out, 2 ** act_bits - 1)


@dataclasses.dataclass
class StreamlinedMLP:
    """A fully streamlined MLP: integer in, integer threshold stages, one
    final float affine head (logits need no quantizing: paper §3.1.1
    drops the softmax, since the argmax of the logits suffices)."""

    in_scale: float
    stages: List[ThresholdDense]
    head_w: torch.Tensor
    head_b: torch.Tensor

    def __call__(self, x_int: torch.Tensor) -> torch.Tensor:
        h = x_int
        for st in self.stages:
            h = apply_threshold_dense(st, h)
        # the int accumulation, one float rescale at the very end
        last_scale = self.stages[-1].out_scale if self.stages else \
            self.in_scale
        return h.to(torch.float32) @ self.head_w * last_scale + self.head_b

    def predict(self, x_int: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self(x_int), dim=-1)

    def to(self, device) -> "StreamlinedMLP":
        return dataclasses.replace(
            self, stages=[st.to(device) for st in self.stages],
            head_w=self.head_w.to(device), head_b=self.head_b.to(device))


def _host_params(p) -> dict:
    """A parameter dict (numpy, torch or a ``core.qlayers`` layer's
    ``to_numpy()``) as float32 tensors on the host."""
    return {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).to(torch.float32)
            for k, v in p.items()}


def streamline_mlp(layer_defs: Sequence, params_list: Sequence,
                   in_scale: float, head_params,
                   bn_eps: float = 1e-3) -> StreamlinedMLP:
    """Streamline a stack of quantized dense(+BN)+ReLU stages and a linear
    head; ``layer_defs`` give ``weight_bits`` / ``act_bits`` (the QAT
    layers themselves, or ``qir.LayerBits``). Built on the host; move the
    result with ``.to(device)``."""
    stages = []
    scale = in_scale
    for ld, p in zip(layer_defs, params_list):
        st = streamline_dense(_host_params(p), weight_bits=ld.weight_bits,
                              act_bits=ld.act_bits, in_scale=scale,
                              bn_eps=bn_eps)
        stages.append(st)
        scale = st.out_scale
    head = _host_params(head_params)
    return StreamlinedMLP(in_scale=in_scale, stages=stages,
                          head_w=head["w"], head_b=head["b"])


def constant_fold(graph):
    """QIR constant folding (paper §3.5 step 1): precompute Quant nodes
    whose inputs are all initializers. Operates on ``core.qir.Graph``."""
    changed = True
    while changed:
        changed = False
        for node in list(graph.nodes):
            if node.op in ("Quant",) and all(i in graph.initializers
                                             for i in node.inputs):
                x = graph.initializers[node.inputs[0]]
                q = IntQuantizer(bits=node.attrs.get("bits", 8))
                graph.initializers[node.outputs[0]] = q(
                    torch.as_tensor(np.asarray(x))).numpy()
                graph.nodes.remove(node)
                changed = True
    return graph
