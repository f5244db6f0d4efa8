"""QIR — the QONNX-style interchange graph, read and run with torch.

The port of ``repro.core.qir``: the same dataclasses and the same JSON
(initializers as base64 npy), so the port reads and writes the very
``*.qir.json`` files the JAX package does, byte for byte. ``Graph.run`` is
the unfused per-node reference interpreter on torch tensors;
``export_qmlp`` and ``export_qcnn`` build the QIR graph of a quantized MLP
and of the IC / CNV conv models from numpy parameter dicts, on the host.

Quant node semantics (attrs select the flavor):
  * default             — dynamic min-max IntQuantizer (the QAT fake-quant)
  * ``attrs["scale"]``  — fixed-grid unsigned quant with half-up rounding,
    value = clip(floor(x/s + 0.5), 0, 2^bits - 1) * s
  * ``attrs["bipolar"]``— FINN's bipolar activation in unipolar encoding:
    value = [x >= 0] in {0, 1}
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import io
import json
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.conv_threshold import (pad_nhwc, same_pad_1d,
                                                same_pads)


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means the card, and there is no
    silent fallback to the CPU — asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain CPU path")
    return dev


@contextlib.contextmanager
def full_fp32():
    """Run float32 matmuls and convolutions in full float32 on CUDA.

    ``torch.backends.cudnn.allow_tf32`` is True by default, so a float32
    convolution on the card would round its inputs to TF32;
    ``torch.backends.cuda.matmul.allow_tf32`` is False by default but a
    caller may have set it. The reference paths (``Graph.run``, the float
    head) must not lose precision, so both flags are False inside this
    block and restored after it."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


@dataclasses.dataclass
class QuantSpec:
    bits: int = 8
    signed: bool = True
    narrow: bool = False
    po2_scale: bool = False

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


@dataclasses.dataclass
class Node:
    op: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict = dataclasses.field(default_factory=dict)
    quant: Optional[QuantSpec] = None

    def to_dict(self):
        d = {
            "op": self.op,
            "name": self.name,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": self.attrs,
        }
        if self.quant is not None:
            d["quant"] = self.quant.to_dict()
        return d

    @classmethod
    def from_dict(cls, d):
        q = QuantSpec.from_dict(d["quant"]) if "quant" in d else None
        return cls(d["op"], d["name"], d["inputs"], d["outputs"], d.get("attrs", {}), q)


def _enc(a: np.ndarray) -> Dict:
    buf = io.BytesIO()
    np.save(buf, np.asarray(a), allow_pickle=False)
    return {"b64": base64.b64encode(buf.getvalue()).decode("ascii")}


def _dec(d: Dict) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(d["b64"])), allow_pickle=False)


@dataclasses.dataclass
class Graph:
    nodes: List[Node] = dataclasses.field(default_factory=list)
    initializers: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    inputs: List[str] = dataclasses.field(default_factory=list)
    outputs: List[str] = dataclasses.field(default_factory=list)
    meta: Dict = dataclasses.field(default_factory=dict)

    # -- serialization ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "nodes": [n.to_dict() for n in self.nodes],
                "initializers": {k: _enc(v) for k, v in self.initializers.items()},
                "inputs": self.inputs,
                "outputs": self.outputs,
                "meta": self.meta,
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "Graph":
        d = json.loads(s)
        return cls(
            nodes=[Node.from_dict(n) for n in d["nodes"]],
            initializers={k: _dec(v) for k, v in d["initializers"].items()},
            inputs=d["inputs"],
            outputs=d["outputs"],
            meta=d.get("meta", {}),
        )

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Graph":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- execution (reference interpreter) --------------------------------
    def run(self, feeds: Dict[str, np.ndarray], device=None
            ) -> Dict[str, np.ndarray]:
        """Interpret the graph node by node on ``device`` (None = CUDA);
        numpy in, numpy out."""
        dev = resolve_device(device)
        env: Dict[str, torch.Tensor] = {
            k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in self.initializers.items()}
        env.update({k: torch.as_tensor(np.asarray(v), device=dev)
                    for k, v in feeds.items()})
        with full_fp32():
            for node in self.nodes:
                env[node.outputs[0]] = eval_node(
                    node, [env[i] for i in node.inputs])
        return {o: env[o].cpu().numpy() for o in self.outputs}


# ---------------------------------------------------------------------------
# single-node evaluation (shared by Graph.run and the deploy fallback stage)
# ---------------------------------------------------------------------------

def max_pool_nhwc(x: torch.Tensor, window: int, stride: int,
                  padding: str = "VALID") -> torch.Tensor:
    """``lax.reduce_window(max)`` over NHWC as a maximum of strided slices
    — exact for integer codes on any device. SAME pads with the dtype's
    minimum (integers) or -inf (floats), so padded taps never win."""
    n, h, w, c = x.shape
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
        pad_h, pad_w = same_pads(h, w, oh, ow, stride, window)
        init = (torch.iinfo(x.dtype).min if not x.dtype.is_floating_point
                else -float("inf"))
        x = pad_nhwc(x, pad_h, pad_w, value=init)
    else:
        oh, ow = (h - window) // stride + 1, (w - window) // stride + 1
    y = None
    for i in range(window):
        for j in range(window):
            s = x[:, i:i + stride * (oh - 1) + 1:stride,
                  j:j + stride * (ow - 1) + 1:stride, :]
            y = s if y is None else torch.maximum(y, s)
    return y


def conv2d_nhwc(a: torch.Tensor, w: torch.Tensor, stride: int,
                padding: str) -> torch.Tensor:
    """``lax.conv_general_dilated`` with NHWC input, HWIO weights and NHWC
    output: SAME pads as XLA does (``same_pad_1d``), VALID not at all.

    cuDNN is off for the call: on the card it may take an inexact algorithm
    for a float32 convolution even with TF32 off (on the full-width CNV its
    conv1 came out up to 3.4e-5 off the integer sums, and signs at the
    thresholds flipped); PyTorch's own convolution sums the products in
    float32, exact while the sums stay below 2^24, as on the CPU."""
    if padding == "SAME":
        h, wd = a.shape[1], a.shape[2]
        a = pad_nhwc(a, same_pad_1d(h, -(-h // stride), stride, w.shape[0]),
                     same_pad_1d(wd, -(-wd // stride), stride, w.shape[1]))
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        y = F.conv2d(a.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride)
    finally:
        torch.backends.cudnn.enabled = enabled
    return y.permute(0, 2, 3, 1)


def _promote(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def eval_node(node: Node, x: List[torch.Tensor]) -> torch.Tensor:
    """Evaluate one QIR node on already-fetched tensor inputs."""
    from repro_torch.core.quantizers import IntQuantizer
    from repro_torch.core.streamline import multi_threshold

    if node.op == "Dense":
        a, w = _promote(x[0], x[1])
        y = a @ w
        if len(x) > 2:
            y = y + x[2]
    elif node.op == "Conv2D":
        a, w = _promote(x[0], x[1])
        y = conv2d_nhwc(a, w, int(node.attrs.get("stride", 1)),
                        node.attrs.get("padding", "SAME"))
        if len(x) > 2:
            y = y + x[2]
    elif node.op == "MaxPool":
        win = int(node.attrs.get("window", 2))
        stride = int(node.attrs.get("stride", win))
        y = max_pool_nhwc(x[0], win, stride, node.attrs.get("padding", "VALID"))
    elif node.op == "Flatten":
        y = x[0].reshape(x[0].shape[0], -1)
    elif node.op == "Relu":
        y = torch.clamp(x[0], min=0)
    elif node.op == "BatchNorm":
        xx, gamma, beta, mu, var = x
        eps = node.attrs.get("eps", 1e-3)
        y = gamma * (xx - mu) / torch.sqrt(var + eps) + beta
    elif node.op == "Quant":
        if node.attrs.get("bipolar"):
            y = (x[0] >= 0).to(torch.float32)
        elif node.attrs.get("scale") is not None:
            s = float(node.attrs["scale"])
            qmax = 2 ** node.quant.bits - 1
            y = torch.clamp(torch.floor(x[0] / s + 0.5), 0, qmax) * s
        else:
            q = IntQuantizer(bits=node.quant.bits, signed=node.quant.signed,
                             narrow=node.quant.narrow)
            y = q(x[0])
    elif node.op == "MultiThreshold":
        y = multi_threshold(x[0].to(torch.int32), x[1])
    elif node.op == "TopK":
        y = torch.argmax(x[0], dim=-1)
    elif node.op == "Mul":
        a, b = _promote(x[0], x[1])
        y = a * b
    else:
        raise NotImplementedError(f"QIR op {node.op}")
    return y


# ---------------------------------------------------------------------------
# exporter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerBits:
    """The per-layer precision ``export_qmlp`` reads (the reference reads
    the same two attributes off its QAT layer objects)."""

    weight_bits: int = 8
    act_bits: int = 8


def export_qmlp(layer_defs, params_list, head_params, meta=None,
                freeze_scales: bool = False,
                in_scale: float = 1.0 / 127.0,
                bn_eps: float = 1e-3) -> Graph:
    """Export a dense(+BatchNorm)+ReLU+quant stack and a linear head to QIR.

    ``layer_defs`` are objects with ``weight_bits`` and ``act_bits``
    (``LayerBits``), ``params_list`` numpy dicts with ``w``, ``b`` and
    optionally ``gamma``, ``beta``, ``mu``, ``sigma2``; ``head_params``
    holds ``w`` and ``b``. The JSON is identical to the reference
    exporter's on the same parameters.

    With ``freeze_scales`` the activation Quant nodes carry the po2 scale
    the streamliner would pick (chained from ``in_scale``), so ``Graph.run``
    uses the same half-up grid as the compiled integer schedule. ``bn_eps``
    must match the value later passed to ``lower_graph``.
    """
    from repro_torch.core.streamline import _fold_affine, choose_act_scale

    g = Graph(inputs=["x"], outputs=["logits"], meta=meta or {})
    prev = "x"
    scale = in_scale
    for i, (ld, p) in enumerate(zip(layer_defs, params_list)):
        wname, bname = f"w{i}", f"b{i}"
        g.initializers[wname] = np.asarray(p["w"])
        g.initializers[bname] = np.asarray(p["b"])
        out = f"h{i}_fc"
        g.nodes.append(
            Node(
                "Dense",
                f"dense{i}",
                [prev, wname, bname],
                [out],
                attrs={"weight_bits": getattr(ld, "weight_bits", 8)},
            )
        )
        prev = out
        if "gamma" in p:
            for stat in ("gamma", "beta", "mu", "sigma2"):
                g.initializers[f"{stat}{i}"] = np.asarray(p[stat])
            out = f"h{i}_bn"
            g.nodes.append(
                Node(
                    "BatchNorm",
                    f"bn{i}",
                    [prev, f"gamma{i}", f"beta{i}", f"mu{i}", f"sigma2{i}"],
                    [out],
                )
            )
            prev = out
        out = f"h{i}_relu"
        g.nodes.append(Node("Relu", f"relu{i}", [prev], [out]))
        prev = out
        out = f"h{i}_q"
        attrs = {}
        if freeze_scales:
            k_f, b_f = _fold_affine(
                {k: torch.tensor(np.asarray(v)) for k, v in p.items()},
                bn_eps)
            s_out = choose_act_scale(k_f, b_f, in_scale=scale,
                                     act_bits=ld.act_bits)
            attrs["scale"] = s_out
            scale = s_out
        g.nodes.append(
            Node(
                "Quant",
                f"quant{i}",
                [prev],
                [out],
                attrs=attrs,
                quant=QuantSpec(bits=ld.act_bits,
                                signed=not freeze_scales),
            )
        )
        prev = out
    g.initializers["w_head"] = np.asarray(head_params["w"])
    g.initializers["b_head"] = np.asarray(head_params["b"])
    g.nodes.append(Node("Dense", "head", [prev, "w_head", "b_head"], ["logits"]))
    return g


def _conv_out_hw(h: int, w: int, k: int, stride: int, padding: str):
    if padding == "SAME":
        return -(-h // stride), -(-w // stride)
    return (h - k) // stride + 1, (w - k) // stride + 1


def export_qcnn(model, params, in_scale: float = 1.0 / 128.0, meta=None,
                calibrate=None) -> Graph:
    """Export a Table-1 conv model (``models.tiny.ICModel`` or
    ``CNVModel``) to QIR, from numpy parameter dicts (``init_numpy``, or
    the reference's ``init`` converted to numpy). The JSON is identical to
    the reference exporter's on the same parameters.

    Every conv layer becomes ``Conv2D -> [Relu] -> Quant``, plus
    ``MaxPool``/``Flatten`` where the architecture has them. Weights are
    stored fake-quantized with po2 per-channel scales (``attrs["w_scale"]``)
    and biases snapped to the accumulator grid, so with a po2 ``in_scale``
    every float of ``Graph.run`` is an exact multiple of a po2 step; the
    binary CNV is exported in FINN's unipolar form (``[x >= 0]`` codes,
    downstream weights folded as ``w' = 2w, b' = b - sum(w)``, its
    ``meta["in_scale"]`` 1.0).

    ``calibrate`` (IC only) is a batch of integer input codes: each layer's
    scale then covers its measured post-ReLU maximum instead of the
    worst-case reach, which leaves most codes at 0. The calibration runs on
    the host in float32; it is exact while every accumulator stays under
    2^24 steps of its po2 grid, which holds at the paper's widths
    (``tests/test_torch_qcnn.py`` checks the bound on its data).
    """
    if getattr(model, "weight_bits", 8) == 1 and hasattr(model, "channels"):
        return _export_cnv(model, params, meta)
    if hasattr(model, "conv_layers"):
        return _export_ic(model, params, in_scale, meta, calibrate)
    raise TypeError(f"no QIR conv exporter for {type(model).__name__}")


def _export_ic(model, params, in_scale: float, meta, calibrate=None) -> Graph:
    from repro_torch.core.quantizers import IntQuantizer, quantize_po2
    from repro_torch.core.streamline import choose_act_scale

    g = Graph(inputs=["x"], outputs=["logits"],
              meta=dict(meta or {}, model=type(model).__name__,
                        in_scale=in_scale))
    convs = model.conv_layers()
    h, w, cin = model.in_hw, model.in_hw, model.in_ch
    scale, in_qmax = in_scale, 127          # signed 8-bit input codes
    hcal = (None if calibrate is None
            else torch.as_tensor(np.asarray(calibrate), dtype=torch.float32)
            * in_scale)
    prev = "x"
    for i, (ld, p) in enumerate(zip(convs, params["convs"])):
        wk = np.asarray(p["w"], np.float32)             # (k, k, cin, f)
        wq = IntQuantizer(bits=ld.weight_bits, signed=True, narrow=True,
                          axis=0, po2=True)
        w_int, s_w = wq.quantize_int(torch.tensor(wk.reshape(-1, ld.out_ch)))
        s_w = s_w.numpy().astype(np.float32).reshape(-1)   # (f,) po2
        w_hat = (w_int.numpy().astype(np.float32) * s_w).reshape(wk.shape)
        grid = s_w * scale                              # accumulator step
        b_q = np.asarray(np.round(np.asarray(p["b"]) / grid) * grid,
                         np.float32)
        oh, ow = _conv_out_hw(h, w, ld.kernel, ld.stride, ld.padding)
        g.initializers[f"cw{i}"] = w_hat
        g.initializers[f"cb{i}"] = b_q
        g.initializers[f"cws{i}"] = s_w
        g.nodes.append(Node(
            "Conv2D", f"conv{i}", [prev, f"cw{i}", f"cb{i}"], [f"c{i}_conv"],
            attrs={"kernel": ld.kernel, "stride": ld.stride,
                   "padding": ld.padding, "weight_bits": ld.weight_bits,
                   "w_scale": f"cws{i}",
                   "in_shape": [h, w, cin], "out_shape": [oh, ow, ld.out_ch]}))
        g.nodes.append(Node("Relu", f"relu{i}", [f"c{i}_conv"], [f"c{i}_relu"]))
        qmax_out = 2 ** ld.act_bits - 1
        if hcal is not None:
            # float32 as the reference's conv; on a card cuDNN would
            # round to TF32, hence full_fp32
            with full_fp32():
                y = conv2d_nhwc(hcal, torch.as_tensor(w_hat).to(hcal.device),
                                ld.stride, ld.padding)
            r = torch.clamp(y + torch.as_tensor(b_q).to(y.device), min=0)
            s_out = float(quantize_po2(
                torch.clamp(torch.amax(r), min=1e-8) / qmax_out))
            hcal = torch.clamp(torch.floor(r / s_out + 0.5), 0,
                               qmax_out) * s_out
        else:
            s_out = choose_act_scale(
                w_hat.reshape(-1, ld.out_ch), b_q,
                in_scale=scale, act_bits=ld.act_bits, in_qmax=in_qmax)
        g.nodes.append(Node(
            "Quant", f"quant{i}", [f"c{i}_relu"], [f"c{i}_q"],
            attrs={"scale": s_out},
            quant=QuantSpec(bits=ld.act_bits, signed=False)))
        prev = f"c{i}_q"
        scale, in_qmax = s_out, 2 ** ld.act_bits - 1
        h, w, cin = oh, ow, ld.out_ch
    g.nodes.append(Node("Flatten", "flatten", [prev], ["flat"],
                        attrs={"in_shape": [h, w, cin]}))
    wq_head = IntQuantizer(bits=model.weight_bits, axis=0)
    g.initializers["w_head"] = wq_head(torch.tensor(np.asarray(
        params["head"]["w"], np.float32))).numpy()
    g.initializers["b_head"] = np.asarray(params["head"]["b"], np.float32)
    g.nodes.append(Node("Dense", "head", ["flat", "w_head", "b_head"],
                        ["logits"]))
    return g


def _export_cnv(model, params, meta) -> Graph:
    g = Graph(inputs=["x"], outputs=["logits"],
              meta=dict(meta or {}, model=type(model).__name__,
                        in_scale=1.0))
    convs = model.conv_layers()
    h, w, cin = model.in_hw, model.in_hw, model.in_ch
    prev = "x"
    for i, (ld, p) in enumerate(zip(convs, params["convs"])):
        sgn = np.where(np.asarray(p["w"]) >= 0, 1.0, -1.0).astype(np.float32)
        if i == 0:
            wk, b_q = sgn, None       # signed input codes: plain +-1 taps
        else:
            wk = 2.0 * sgn            # unipolar folding: x = 2q - 1
            b_q = -np.sum(sgn, axis=(0, 1, 2)).astype(np.float32)
        oh, ow = _conv_out_hw(h, w, ld.kernel, ld.stride, ld.padding)
        g.initializers[f"cw{i}"] = wk
        g.initializers[f"cws{i}"] = np.ones((ld.out_ch,), np.float32)
        ins = [prev, f"cw{i}"]
        if b_q is not None:
            g.initializers[f"cb{i}"] = b_q
            ins.append(f"cb{i}")
        g.nodes.append(Node(
            "Conv2D", f"conv{i}", ins, [f"c{i}_conv"],
            attrs={"kernel": ld.kernel, "stride": ld.stride,
                   "padding": ld.padding, "weight_bits": 1,
                   "w_scale": f"cws{i}",
                   "in_shape": [h, w, cin], "out_shape": [oh, ow, ld.out_ch]}))
        g.nodes.append(Node("Quant", f"sign{i}", [f"c{i}_conv"], [f"c{i}_q"],
                            attrs={"bipolar": True},
                            quant=QuantSpec(bits=1, signed=False)))
        prev = f"c{i}_q"
        h, w, cin = oh, ow, ld.out_ch
        if i in model.pool_after:
            g.nodes.append(Node(
                "MaxPool", f"pool{i}", [prev], [f"p{i}"],
                attrs={"window": 2, "stride": 2, "padding": "VALID",
                       "in_shape": [h, w, cin],
                       "out_shape": [h // 2, w // 2, cin]}))
            prev = f"p{i}"
            h, w = h // 2, w // 2
    g.nodes.append(Node("Flatten", "flatten", [prev], ["flat"],
                        attrs={"in_shape": [h, w, cin]}))
    prev = "flat"
    dims = [h * w * cin, *model.fc, model.n_classes]
    for j, p in enumerate(params["fcs"]):
        sgn = np.where(np.asarray(p["w"]) >= 0, 1.0, -1.0).astype(np.float32)
        g.initializers[f"fw{j}"] = 2.0 * sgn
        g.initializers[f"fb{j}"] = -np.sum(sgn, axis=0).astype(np.float32)
        last = j == len(params["fcs"]) - 1
        out = "logits" if last else f"f{j}_fc"
        attrs = {"weight_bits": 1}
        if not last:
            g.initializers[f"fws{j}"] = np.ones((dims[j + 1],), np.float32)
            attrs["w_scale"] = f"fws{j}"
        g.nodes.append(Node("Dense", f"fc{j}", [prev, f"fw{j}", f"fb{j}"],
                            [out], attrs=attrs))
        if not last:
            g.nodes.append(Node("Quant", f"fsign{j}", [out], [f"f{j}_q"],
                                attrs={"bipolar": True},
                                quant=QuantSpec(bits=1, signed=False)))
            prev = f"f{j}_q"
    return g
