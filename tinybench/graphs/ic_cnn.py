"""Graph generator of the hls4ml IC model family (8-bit CNN, SAME convs).

Reads the sizes of a configuration file (``in_hw``, ``in_ch``,
``filters``, ``kernels``, ``strides``, ``padding``, ``weight_bits``,
``act_bits``, ``n_classes``, ``in_scale``, ``calibration_samples``) and a
seed, and returns the QIR graph the benchmark hands the program:

  * Glorot-uniform conv and head weights, zero biases, drawn from
    ``numpy.random.default_rng(seed)`` in layer order (the port's
    ``bench.models.ic_graph`` draws, frozen here);
  * each conv weight quantized per output channel to ``weight_bits``
    narrow codes with a power-of-two scale, the bias snapped to the
    accumulator grid;
  * each activation scale a power of two covering the layer's post-ReLU
    maximum over ``calibration_samples`` input codes in [-127, 127] drawn
    from ``default_rng(seed + 1)``, so most codes of every stage are off
    zero (worst-case scales would leave the deep stages at 0);
  * the head's weights fake-quantized per column to 8 bits (min-max
    scale), in float32.

The calibration runs in float64 (the reference's convolution), where
every sum of the power-of-two grid is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from tinybench.qir import QirGraph, conv_out_hw, glorot, po2
from tinybench.reference import conv2d


def make_graph(cfg: dict, seed: int) -> dict:
    seed = int(seed)
    rng = np.random.default_rng(seed)
    h = w = int(cfg["in_hw"])
    cin = int(cfg["in_ch"])
    wbits, abits = int(cfg["weight_bits"]), int(cfg["act_bits"])
    pad = cfg["padding"]
    layers = []
    for f, k, s in zip(cfg["filters"], cfg["kernels"], cfg["strides"]):
        layers.append((cin, int(f), int(k), int(s)))
        cin = int(f)
    raw = [glorot(rng, (k, k, ci, f), ci * k * k, f * k * k)
           for ci, f, k, s in layers]
    oh = ow = int(cfg["in_hw"])
    for _, _, k, s in layers:
        oh, ow = conv_out_hw(oh, ow, k, s, pad)
    flat = oh * ow * layers[-1][1]
    n_cls = int(cfg["n_classes"])
    head_w = glorot(rng, (flat, n_cls), flat, n_cls)

    in_scale = float(cfg["in_scale"])
    g = QirGraph(meta={"model": "ICModel", "in_scale": in_scale})
    cal = np.random.default_rng(seed + 1).integers(
        -127, 128, (int(cfg["calibration_samples"]), h, w, int(cfg["in_ch"])),
        dtype=np.int32)
    hcal = cal.astype(np.float64) * in_scale
    scale, qmax_w, qmax_a = np.float32(in_scale), 2 ** (wbits - 1) - 1, \
        2 ** abits - 1
    prev, cin = "x", int(cfg["in_ch"])
    for i, ((_, f, k, s), wk) in enumerate(zip(layers, raw)):
        w2 = wk.reshape(-1, f)
        s_w = po2(np.maximum(np.abs(w2).max(axis=0), np.float32(1e-8))
                  / np.float32(qmax_w))
        w_int = np.clip(np.round(w2 / s_w), -qmax_w, qmax_w)
        w_hat = (w_int.astype(np.float32) * s_w).reshape(wk.shape)
        grid = s_w * scale
        b_q = (np.round(np.zeros(f, np.float32) / grid) * grid).astype(
            np.float32)
        ho, wo = conv_out_hw(h, w, k, s, pad)
        g.const(f"cw{i}", w_hat)
        g.const(f"cb{i}", b_q)
        g.const(f"cws{i}", s_w)
        g.add("Conv2D", f"conv{i}", [prev, f"cw{i}", f"cb{i}"],
              [f"c{i}_conv"],
              attrs={"kernel": k, "stride": s, "padding": pad,
                     "weight_bits": wbits, "w_scale": f"cws{i}",
                     "in_shape": [h, w, cin], "out_shape": [ho, wo, f]})
        g.add("Relu", f"relu{i}", [f"c{i}_conv"], [f"c{i}_relu"])
        y = conv2d(torch.as_tensor(hcal),
                   torch.as_tensor(w_hat.astype(np.float64)), s, pad).numpy()
        r = np.maximum(y + b_q, 0.0)
        s_out = float(po2(np.float32(max(float(r.max()), 1e-8))
                          / np.float32(qmax_a)))
        hcal = np.clip(np.floor(r / s_out + 0.5), 0, qmax_a) * s_out
        g.add("Quant", f"quant{i}", [f"c{i}_relu"], [f"c{i}_q"],
              attrs={"scale": s_out}, quant={"bits": abits})
        prev, scale = f"c{i}_q", np.float32(s_out)
        h, w, cin = ho, wo, f
    g.add("Flatten", "flatten", [prev], ["flat"],
          attrs={"in_shape": [h, w, cin]})
    s_h = np.maximum(np.abs(head_w).max(axis=0, keepdims=True),
                     np.float32(1e-8)) / np.float32(127)
    g.const("w_head", np.clip(np.round(head_w / s_h), -128, 127) * s_h)
    g.const("b_head", np.zeros(n_cls, np.float32))
    g.add("Dense", "head", ["flat", "w_head", "b_head"], ["logits"])
    return g.to_dict()
