"""Full-width tiny models for the card, from numpy-seeded parameters.

The paper's four Table-1 models at their published widths: the KWS MLP
and AD autoencoder built with ``core.qir.export_qmlp``, the IC CNN and
CNV-W1A1 with ``core.qir.export_qcnn`` from ``models.tiny`` (JAX's PRNG
cannot be reproduced, so the weights come from
``numpy.random.default_rng``). ``chip_smoke.py`` drives all four on the
main path, the autotuner and the scenarios; the kernel bench runs KWS and
AD head to head in both dispatch modes; the tests feed the same JSON to
the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.qir import Graph, LayerBits, export_qcnn, export_qmlp
from repro_torch.models.tiny import CNVModel, ICModel

#: KWS: 490 inputs, three 256-wide hidden layers, 12 classes, 3-bit.
KWS_DIMS, KWS_BITS = (490, 256, 256, 256, 12), 3
#: AD: the 128-72-72-8-72-72-128 autoencoder, 8-bit.
AD_DIMS, AD_BITS = (128, 72, 72, 8, 72, 72, 128), 8
#: IC's input step: the 8-bit image codes in [-127, 127] times 2^-7 (the
#: exporter's default, a power of two so the graph stays exact).
IC_IN_SCALE = 1.0 / 128.0
#: Samples of seeded input codes IC's scales are calibrated on.
IC_CALIBRATION_SAMPLES = 64


def mlp_graph(dims: Sequence[int], bits: int, seed: int,
              name: Optional[str] = None) -> Graph:
    """A QIR MLP of widths ``dims`` from numpy-seeded parameters, BN
    statistics away from the identity so the BN fold is exercised.
    ``name`` goes to the graph's ``meta["model"]`` when given."""
    dims = list(dims)
    rng = np.random.default_rng(seed)
    hidden = []
    scale, in_qmax, qmax = 1.0 / 127.0, 2 ** (bits - 1) - 1, 2 ** bits - 1
    for i in range(len(dims) - 2):
        fan_in, fan_out = dims[i], dims[i + 1]
        p = {"w": (rng.standard_normal((fan_in, fan_out))
                   * np.sqrt(2.0 / fan_in)).astype(np.float32),
             "b": (0.05 * rng.standard_normal(fan_out)).astype(np.float32),
             "gamma": rng.uniform(0.5, 1.5, fan_out).astype(np.float32),
             "mu": (0.2 * rng.standard_normal(fan_out)).astype(np.float32),
             "sigma2": rng.uniform(0.5, 2.0, fan_out).astype(np.float32)}
        # the frozen scale covers the worst-case reach, which random inputs
        # never approach; a BN shift of -10..20% of that reach keeps about
        # half of every layer's codes off zero, so deep stages see
        # non-trivial inputs
        v = p["gamma"] / np.sqrt(p["sigma2"] + 1e-3)
        reach = np.abs(p["w"] * v).sum(axis=0) * scale * in_qmax
        p["beta"] = (rng.uniform(-0.1, 0.2, fan_out) * reach.max()
                     ).astype(np.float32)
        b_f = v * (p["b"] - p["mu"]) + p["beta"]
        scale = 2.0 ** np.round(np.log2((reach + np.abs(b_f)).max() / qmax))
        hidden.append(p)
    w = rng.standard_normal((dims[-2], dims[-1])) * np.sqrt(1.0 / dims[-2])
    # zero column sums: the codes' common offset does not pick the class
    head = {"w": (w - w.mean(axis=0)).astype(np.float32),
            "b": (0.01 * rng.standard_normal(dims[-1])).astype(np.float32)}
    layers = [LayerBits(weight_bits=bits, act_bits=bits)] * (len(dims) - 2)
    return export_qmlp(layers, hidden, head, freeze_scales=True,
                       in_scale=1.0 / 127.0,
                       meta=None if name is None else {"model": name})


def ic_graph(seed: int, calibrate: bool = True) -> Graph:
    """The paper's IC CNN (``ICModel()``: 32x32x3, filters 32-4-32-32-4)
    from ``init_numpy(seed)``. With ``calibrate`` each layer's scale covers
    its post-ReLU maximum on ``IC_CALIBRATION_SAMPLES`` seeded input codes
    in [-127, 127]; the worst-case scales of ``calibrate=False`` leave most
    codes at 0. The graph's ``meta["in_scale"]`` is ``IC_IN_SCALE``."""
    model = ICModel()
    cal = None
    if calibrate:
        rng = np.random.default_rng(seed + 1)
        cal = rng.integers(-127, 128, (IC_CALIBRATION_SAMPLES, model.in_hw,
                                       model.in_hw, model.in_ch),
                           dtype=np.int32)
    return export_qcnn(model, model.init_numpy(seed), in_scale=IC_IN_SCALE,
                       calibrate=cal)


def cnv_graph(seed: int) -> Graph:
    """CNV-W1A1 at the paper's width (``CNVModel()``: 64-64-128-128-256-256,
    FC 512-512-10, 1,542,848 weights) from ``init_numpy(seed)``; its input
    codes are the values (``meta["in_scale"]`` 1.0)."""
    model = CNVModel()
    return export_qcnn(model, model.init_numpy(seed))
