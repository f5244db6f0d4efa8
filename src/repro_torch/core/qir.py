"""QIR — the QONNX-style interchange graph, read and run with torch.

The port of ``repro.core.qir``: the same dataclasses and the same JSON
(initializers as base64 npy), so the port reads and writes the very
``*.qir.json`` files the JAX package does, byte for byte. ``Graph.run`` is
the unfused per-node reference interpreter on torch tensors;
``export_qmlp`` builds the QIR graph of a quantized MLP from numpy
parameter dicts.

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
        stride = int(node.attrs.get("stride", 1))
        a, w = _promote(x[0], x[1])
        if node.attrs.get("padding", "SAME") == "SAME":
            h, wd = a.shape[1], a.shape[2]
            a = pad_nhwc(a, same_pad_1d(h, -(-h // stride), stride, w.shape[0]),
                         same_pad_1d(wd, -(-wd // stride), stride, w.shape[1]))
        y = F.conv2d(a.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride).permute(0, 2, 3, 1)
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
