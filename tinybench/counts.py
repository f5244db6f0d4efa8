"""The benchmark's own counts of work and its table of peaks (the yardstick).

Counted from the benchmark's QIR graph (``graphs/``), whatever implements
it:

  * operations: 2 per multiply-add of every convolution and dense layer,
    the head included; binary layers count alike, since they run on the
    int8 tensor cores;
  * a threshold convolution's bytes (K2, ``conv_threshold``): each code
    of its input and its output once at 1 byte whatever its bit width,
    each weight once at 1 byte, each threshold once at 4 bytes (a channel
    of an n-bit activation has 2^n - 1 thresholds, a bipolar one 1);
  * a kernel's bound: max(bytes / HBM bandwidth, operations / int8 peak).

Peaks: NVIDIA's data sheet for one H100 SXM, dense: 1,979e12 int8 OP/s,
3.35e12 bytes/s of HBM, both at the 700 W power limit.
"""

from __future__ import annotations

import re
from typing import Dict, List

from tinybench.qir import decode

PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def _shape(graph: dict, name: str):
    return decode(graph["initializers"][name]).shape


def _consumer(graph: dict, value: str):
    for nd in graph["nodes"]:
        if value in nd["inputs"]:
            return nd
    return None


def _act_bits(graph: dict, conv: dict) -> int:
    """Bits of the quantizer that ends a conv's chain (through a Relu)."""
    nd = _consumer(graph, conv["outputs"][0])
    while nd is not None and nd["op"] == "Relu":
        nd = _consumer(graph, nd["outputs"][0])
    if nd is None or nd["op"] != "Quant":
        raise ValueError(f"{conv['name']}: no quantizer ends its chain")
    return 1 if nd["attrs"].get("bipolar") else int(nd["quant"]["bits"])


def conv_layers(graph: dict) -> List[Dict[str, int]]:
    """Per Conv2D node: its shapes, multiply-adds and thresholds a row."""
    out = []
    for nd in graph["nodes"]:
        if nd["op"] != "Conv2D":
            continue
        a = nd["attrs"]
        h, w, c = a["in_shape"]
        oh, ow, f = a["out_shape"]
        k = int(a["kernel"])
        bits = _act_bits(graph, nd)
        out.append({"name": nd["name"], "in_codes": h * w * c,
                    "out_codes": oh * ow * f, "weights": k * k * c * f,
                    "macs": oh * ow * f * k * k * c,
                    "thresholds": f * (1 if bits == 1 else 2 ** bits - 1)})
    return out


def dense_macs(graph: dict) -> int:
    total = 0
    for nd in graph["nodes"]:
        if nd["op"] == "Dense":
            k, n = _shape(graph, nd["inputs"][1])
            total += k * n
    return total


def ops_per_inference(graph: dict) -> int:
    return 2 * (sum(c["macs"] for c in conv_layers(graph))
                + dense_macs(graph))


def conv_bytes(layer: Dict[str, int], rows: int) -> int:
    return (rows * (layer["in_codes"] + layer["out_codes"])
            + layer["weights"] + 4 * layer["thresholds"])


def bound_s(ops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_INT8_OPS)


def conv_threshold_bound_s(graph: dict, rows: int) -> float:
    """K2's least time for one call of ``rows`` rows: the sum of each
    conv layer's bound."""
    return sum(bound_s(2 * rows * c["macs"], conv_bytes(c, rows))
               for c in conv_layers(graph))


#: The program's hand-written kernels by the names the device trace gives
#: them (K1, K2, K3 and the float head, the kernels of the tiny models).
CONV_THRESHOLD_KERNEL = "conv_threshold_kernel"
TABLE_KERNELS = ("threshold_matmul_kernel", CONV_THRESHOLD_KERNEL,
                 "mlp_megakernel_kernel", "float_head_kernel")


def kernel_is(name: str, kernel: str) -> bool:
    """Whether a trace's (demangled) kernel name is ``kernel``'s."""
    return re.search(rf"(^|[^A-Za-z0-9_]){kernel}($|[^A-Za-z0-9_])",
                     name) is not None
