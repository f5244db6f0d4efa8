"""The QIR JSON the benchmark hands the program, and helpers to build it.

A graph is the dict that ``json.dumps`` writes and the program's
``Graph.from_json`` reads: ``nodes`` (op, name, inputs, outputs, attrs,
optional ``quant``), ``initializers`` (each a numpy array saved as ``.npy``
and base64-encoded), ``inputs``, ``outputs`` and ``meta``. The generators
in ``graphs/`` build it from a configuration file and a seed with numpy
alone; the plain reference (``reference.py``) reads it back with
``decode``. Nothing here imports the program.
"""

from __future__ import annotations

import base64
import io
from typing import Dict, List, Optional

import numpy as np


def encode(a: np.ndarray) -> Dict[str, str]:
    buf = io.BytesIO()
    np.save(buf, np.asarray(a), allow_pickle=False)
    return {"b64": base64.b64encode(buf.getvalue()).decode("ascii")}


def decode(d: Dict[str, str]) -> np.ndarray:
    return np.load(io.BytesIO(base64.b64decode(d["b64"])), allow_pickle=False)


def node(op: str, name: str, inputs: List[str], outputs: List[str],
         attrs: Optional[dict] = None, quant: Optional[dict] = None) -> dict:
    d = {"op": op, "name": name, "inputs": list(inputs),
         "outputs": list(outputs), "attrs": dict(attrs or {})}
    if quant is not None:
        d["quant"] = {"bits": int(quant["bits"]),
                      "signed": bool(quant.get("signed", False)),
                      "narrow": bool(quant.get("narrow", False)),
                      "po2_scale": bool(quant.get("po2_scale", False))}
    return d


class QirGraph:
    """Collects nodes and float32 initializers; ``to_dict`` gives the
    graph."""

    def __init__(self, meta: Optional[dict] = None):
        self.nodes: List[dict] = []
        self.initializers: Dict[str, np.ndarray] = {}
        self.meta = dict(meta or {})

    def const(self, name: str, value) -> str:
        self.initializers[name] = np.asarray(value, np.float32)
        return name

    def add(self, *args, **kwargs) -> None:
        self.nodes.append(node(*args, **kwargs))

    def to_dict(self) -> dict:
        return {"nodes": self.nodes,
                "initializers": {k: encode(v)
                                 for k, v in self.initializers.items()},
                "inputs": ["x"], "outputs": ["logits"], "meta": self.meta}


def po2(scale) -> np.ndarray:
    """Snap positive scales to the nearest power of two, in float32, with
    the exporter's clamp to [2^-24, 2^24]."""
    s = np.clip(np.asarray(scale, np.float32), np.float32(2.0 ** -24),
                np.float32(2.0 ** 24))
    return np.power(np.float32(2.0),
                    np.round(np.log2(s))).astype(np.float32)


def conv_out_hw(h: int, w: int, k: int, stride: int, padding: str):
    if padding == "SAME":
        return -(-h // stride), -(-w // stride)
    return (h - k) // stride + 1, (w - k) // stride + 1


def same_pad(size: int, out: int, stride: int, k: int):
    """XLA's SAME split of one axis: (before, after)."""
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def glorot(rng: np.random.Generator, shape, fan_in: int, fan_out: int
           ) -> np.ndarray:
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return rng.uniform(-limit, limit, shape).astype(np.float32)
