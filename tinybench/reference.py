"""The plain reference: the benchmark's QIR graph interpreted node by node.

It reads the graph the benchmark generated (``graphs/``), never anything
the program made, and imports neither the program nor JAX: numpy and
plain ``torch`` operations only, in float64, where every value of these
graphs (integer codes times power-of-two steps, sums far below 2^53) is
exact, whatever order a matrix product sums in. Convolutions are a sum of
one matrix product per kernel tap; rows go through in blocks so that a
large sample fits.

``precision="int4"`` is the control the check must reject: every tensor
the configuration states in 8 bits (input codes, weights, activations)
computed in 4 bits instead, on the same grid's top bits. Binary layers
and the float head stay as stated. ``precision="bf16_head"`` runs only the
float head in bfloat16.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from tinybench.qir import conv_out_hw, decode, same_pad

PRECISIONS = ("stated", "int4", "bf16_head")


def _int4(codes: torch.Tensor, lo: int) -> torch.Tensor:
    """8-bit codes on a 4-bit grid of 16 steps each, clipped to 4 bits."""
    return torch.clamp(torch.round(codes / 16.0), lo, 15 if lo == 0 else 7) \
        * 16.0


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int, padding: str
           ) -> torch.Tensor:
    """NHWC x HWIO -> NHWC: one matrix product per kernel tap."""
    n, h, wd, c = x.shape
    k, f = w.shape[0], w.shape[3]
    oh, ow = conv_out_hw(h, wd, k, stride, padding)
    if padding == "SAME":
        (t, b), (le, r) = same_pad(h, oh, stride, k), same_pad(wd, ow,
                                                                stride, k)
        x = torch.nn.functional.pad(x, (0, 0, le, r, t, b))
    y = x.new_zeros((n, oh, ow, f))
    for i in range(k):
        for j in range(k):
            y += x[:, i:i + stride * (oh - 1) + 1:stride,
                   j:j + stride * (ow - 1) + 1:stride, :] @ w[i, j]
    return y


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    n, h, w, c = x.shape
    oh, ow = (h - window) // stride + 1, (w - window) // stride + 1
    y = None
    for i in range(window):
        for j in range(window):
            s = x[:, i:i + stride * (oh - 1) + 1:stride,
                  j:j + stride * (ow - 1) + 1:stride, :]
            y = s if y is None else torch.maximum(y, s)
    return y


class Reference:
    """The graph's initializers as float64 tensors on ``device``, and
    ``run`` over integer input codes."""

    def __init__(self, graph: dict, device="cpu", precision: str = "stated"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.graph = graph
        self.device = torch.device(device)
        self.precision = precision
        self.in_scale = float(graph["meta"]["in_scale"])
        self.consts = {k: torch.as_tensor(decode(v).astype(np.float64),
                                          device=self.device)
                       for k, v in graph["initializers"].items()}
        if precision == "int4":
            for nd in graph["nodes"]:
                if (nd["op"] in ("Conv2D", "Dense")
                        and nd["attrs"].get("weight_bits") == 8):
                    w = self.consts[nd["inputs"][1]]
                    s = self.consts[nd["attrs"]["w_scale"]]
                    self.consts[nd["inputs"][1]] = _int4(torch.round(w / s),
                                                         -7) * s

    def _node(self, nd: dict, x: List[torch.Tensor]) -> torch.Tensor:
        op, a = nd["op"], nd["attrs"]
        if op == "Conv2D":
            y = conv2d(x[0], x[1], int(a.get("stride", 1)),
                       a.get("padding", "SAME"))
            return y + x[2] if len(x) > 2 else y
        if op == "Dense":
            if self.precision == "bf16_head" and "weight_bits" not in a:
                y = (x[0].to(torch.bfloat16) @ x[1].to(torch.bfloat16)
                     ).to(torch.float64)
            else:
                y = x[0] @ x[1]
            return y + x[2] if len(x) > 2 else y
        if op == "Relu":
            return torch.clamp(x[0], min=0.0)
        if op == "Quant":
            if a.get("bipolar"):
                return (x[0] >= 0).to(torch.float64)
            if a.get("scale") is None:
                raise NotImplementedError("a Quant node without a fixed "
                                          "scale has no deployed meaning")
            s, qmax = float(a["scale"]), 2 ** int(nd["quant"]["bits"]) - 1
            q = torch.clamp(torch.floor(x[0] / s + 0.5), 0, qmax)
            if self.precision == "int4" and nd["quant"]["bits"] == 8:
                q = _int4(q, 0)
            return q * s
        if op == "MaxPool":
            if a.get("padding", "VALID") != "VALID":
                raise NotImplementedError("SAME max-pool")
            win = int(a.get("window", 2))
            return max_pool(x[0], win, int(a.get("stride", win)))
        if op == "Flatten":
            return x[0].reshape(x[0].shape[0], -1)
        if op == "BatchNorm":
            xx, gamma, beta, mu, var = x
            return gamma * (xx - mu) / torch.sqrt(var + a.get("eps", 1e-3)) \
                + beta
        raise NotImplementedError(f"QIR op {op}")

    def run(self, codes: np.ndarray, block: int = 512
            ) -> Tuple[np.ndarray, Dict[str, float]]:
        """Logits (float64, numpy) of integer input ``codes`` (N, H, W, C),
        and the share of nonzero codes at each quantizer's output."""
        outs: List[np.ndarray] = []
        nonzero: Dict[str, int] = {}
        total: Dict[str, int] = {}
        for lo in range(0, codes.shape[0], block):
            x = torch.as_tensor(np.asarray(codes[lo:lo + block]),
                                device=self.device).to(torch.float64)
            if self.precision == "int4":
                x = _int4(x, -7)
            env = dict(self.consts)
            env[self.graph["inputs"][0]] = x * self.in_scale
            for nd in self.graph["nodes"]:
                y = self._node(nd, [env[i] for i in nd["inputs"]])
                env[nd["outputs"][0]] = y
                if nd["op"] == "Quant":
                    nonzero[nd["name"]] = nonzero.get(nd["name"], 0) + int(
                        torch.count_nonzero(y))
                    total[nd["name"]] = total.get(nd["name"], 0) + y.numel()
            outs.append(env[self.graph["outputs"][0]].cpu().numpy())
        share = {k: nonzero[k] / total[k] for k in nonzero}
        return np.concatenate(outs), share


def reference_logits(graph: dict, codes: np.ndarray, device="cpu",
                     precision: str = "stated", block: int = 512
                     ) -> Tuple[np.ndarray, Dict[str, float]]:
    return Reference(graph, device, precision).run(codes, block)


def row_gaps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per row, the widest gap between a served logit and the
    reference's, over the reference's largest magnitude in the sample: 0
    where every logit is exact, infinite for every row where the answers
    are missing or not finite."""
    got = np.asarray(got, np.float64)
    if got.shape != ref.shape or not np.all(np.isfinite(got)):
        return np.full(ref.shape[0], np.inf)
    scale = max(float(np.abs(ref).max()), 1e-30)
    return np.abs(got - ref).max(axis=1) / scale


def logit_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """The number the check compares: the widest of ``row_gaps``."""
    return float(row_gaps(got, ref).max())
