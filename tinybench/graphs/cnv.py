"""Graph generator of FINN's CNV family (binary CNN, VALID convs).

Reads the sizes of a configuration file (``in_hw``, ``in_ch``,
``channels``, ``kernel``, ``padding``, ``pool_after``, ``fc``,
``n_classes``) and a seed, and returns the QIR graph the benchmark hands
the program, in FINN's unipolar form:

  * Glorot-uniform weights drawn from ``numpy.random.default_rng(seed)``
    in layer order, convs then FCs (the port's ``bench.models.cnv_graph``
    draws, frozen here), kept by their sign;
  * the first conv takes the signed 8-bit input codes with plain +-1
    taps; every later layer reads {0, 1} codes, so its taps are
    ``2 sign(w)`` and its bias ``-sum(sign(w))`` (x = 2q - 1 folded in);
  * every conv and hidden FC output is a bipolar quantizer (``x >= 0``),
    a 2x2 max-pool follows the convs listed in ``pool_after``, and the
    last FC gives the logits, which are integers.
"""

from __future__ import annotations

import numpy as np

from tinybench.qir import QirGraph, conv_out_hw, glorot


def _sign(w: np.ndarray) -> np.ndarray:
    return np.where(w >= 0, 1.0, -1.0).astype(np.float32)


def make_graph(cfg: dict, seed: int) -> dict:
    rng = np.random.default_rng(int(seed))
    k, pad = int(cfg["kernel"]), cfg["padding"]
    h = w = int(cfg["in_hw"])
    cin = int(cfg["in_ch"])
    chans = [int(c) for c in cfg["channels"]]
    raw, ci = [], cin
    for c in chans:
        raw.append(glorot(rng, (k, k, ci, c), ci * k * k, c * k * k))
        ci = c
    dims = [chans[-1], *[int(d) for d in cfg["fc"]], int(cfg["n_classes"])]
    fcs = [glorot(rng, (dims[j], dims[j + 1]), dims[j], dims[j + 1])
           for j in range(len(dims) - 1)]

    g = QirGraph(meta={"model": "CNVModel", "in_scale": 1.0})
    pool_after = {int(p) for p in cfg["pool_after"]}
    prev = "x"
    for i, (c, wk) in enumerate(zip(chans, raw)):
        sgn = _sign(wk)
        ho, wo = conv_out_hw(h, w, k, 1, pad)
        ins = [prev, f"cw{i}"]
        if i == 0:
            g.const(f"cw{i}", sgn)
        else:
            g.const(f"cw{i}", 2.0 * sgn)
            g.const(f"cb{i}", -np.sum(sgn, axis=(0, 1, 2)))
            ins.append(f"cb{i}")
        g.const(f"cws{i}", np.ones((c,), np.float32))
        g.add("Conv2D", f"conv{i}", ins, [f"c{i}_conv"],
              attrs={"kernel": k, "stride": 1, "padding": pad,
                     "weight_bits": 1, "w_scale": f"cws{i}",
                     "in_shape": [h, w, cin], "out_shape": [ho, wo, c]})
        g.add("Quant", f"sign{i}", [f"c{i}_conv"], [f"c{i}_q"],
              attrs={"bipolar": True}, quant={"bits": 1})
        prev, h, w, cin = f"c{i}_q", ho, wo, c
        if i in pool_after:
            g.add("MaxPool", f"pool{i}", [prev], [f"p{i}"],
                  attrs={"window": 2, "stride": 2, "padding": "VALID",
                         "in_shape": [h, w, cin],
                         "out_shape": [h // 2, w // 2, cin]})
            prev, h, w = f"p{i}", h // 2, w // 2
    g.add("Flatten", "flatten", [prev], ["flat"],
          attrs={"in_shape": [h, w, cin]})
    prev = "flat"
    for j, wf in enumerate(fcs):
        sgn = _sign(wf)
        g.const(f"fw{j}", 2.0 * sgn)
        g.const(f"fb{j}", -np.sum(sgn, axis=0))
        last = j == len(fcs) - 1
        out = "logits" if last else f"f{j}_fc"
        attrs = {"weight_bits": 1}
        if not last:
            g.const(f"fws{j}", np.ones((dims[j + 1],), np.float32))
            attrs["w_scale"] = f"fws{j}"
        g.add("Dense", f"fc{j}", [prev, f"fw{j}", f"fb{j}"], [out],
              attrs=attrs)
        if not last:
            g.add("Quant", f"fsign{j}", [out], [f"f{j}_q"],
                  attrs={"bipolar": True}, quant={"bits": 1})
            prev = f"f{j}_q"
    return g.to_dict()
