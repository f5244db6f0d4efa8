"""Quickstart: the paper's codesign workflow on one page, on the card.

The port of ``examples/quickstart.py``:

1. Build a quantized model (QAT, arbitrary bit width)      [C1]
2. Train it on synthetic data                              [C9]
3. Fold BN + merge ReLU (training-time fusion)             [C3]
4. Streamline to an integer-only threshold graph           [C2]
5. Execute the deployed graph on the fused kernel (K1)     [C4]
6. Report BOPs / weight-memory / roofline latency          [C7]

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The data and the initial weights come from numpy and torch seeds (JAX's
PRNG cannot be reproduced), so the numbers differ from the reference's.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core.bops import ModelCost, dense_cost
from repro_torch.core.codesign import deploy_report, train_tiny
from repro_torch.core.qir import resolve_device
from repro_torch.core.qlayers import QDense, QDenseBatchNorm
from repro_torch.core.streamline import streamline_mlp
from repro_torch.kernels import ops, ref

DIMS, N_CLASSES, BITS = [32, 24, 16], 4, 4
IN_SCALE = 0.1


def make_batch(step: int, protos: np.ndarray, n: int = 64):
    r = np.random.default_rng(step)
    y = r.integers(0, N_CLASSES, n)
    x = protos[y] + 0.5 * r.standard_normal((n, DIMS[0]))
    return x.astype(np.float32), y


def run(device=None, steps: int = 150, verbose: bool = True) -> Dict:
    """The whole workflow; returns the readings (accuracies, losses, the
    streamlined stages, the K1 codes and their plain versions)."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    # --- 1. a 4-bit MLP classifier (QDense+BN stages, merged ReLU) ---------
    g = torch.Generator().manual_seed(0)
    layers = torch.nn.ModuleList(
        [QDenseBatchNorm(DIMS[i], DIMS[i + 1], weight_bits=BITS,
                         act_bits=BITS, generator=g)
         for i in range(len(DIMS) - 1)])
    head = QDense(DIMS[-1], N_CLASSES, weight_bits=32, act_bits=32,
                  generator=g)
    net = torch.nn.ModuleDict({"hidden": layers, "head": head}).to(dev)

    # --- 2. train on a synthetic 4-class problem ----------------------------
    protos = (np.random.default_rng(7).standard_normal((N_CLASSES, DIMS[0]))
              * 2).astype(np.float32)

    def batch(step):
        x, y = make_batch(step, protos)
        return (torch.tensor(x, device=dev),
                torch.tensor(y, dtype=torch.int64, device=dev))

    def forward(x, train=False):
        h = x
        for layer in net["hidden"]:
            h = layer(h, train=train)
        return net["head"](h, train=train)

    def loss_fn(_, b):
        x, y = b
        logits = forward(x)
        return torch.mean(torch.logsumexp(logits, -1)
                          - logits.gather(1, y[:, None])[:, 0])

    batches = [batch(s) for s in range(steps)]
    _, losses = train_tiny(loss_fn, net, lambda t: batches[t], steps=steps,
                           lr=3e-3)
    say(f"[2] QAT training: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # --- 3. BN statistics warm-up (the fold uses running stats) -------------
    with torch.no_grad():
        for s in range(5):
            forward(batch(500 + s)[0], train=True)   # updates mu / sigma2

    # --- 4. streamline: float graph -> integer thresholds -------------------
    smlp = streamline_mlp(list(net["hidden"]),
                          [l.to_numpy() for l in net["hidden"]], IN_SCALE,
                          net["head"].to_numpy()).to(dev)
    say(f"[4] streamlined: {len(smlp.stages)} integer threshold stages, "
        f"out_scales={[f'{s.out_scale:.4f}' for s in smlp.stages]}")

    # --- 5. run the deployed graph on the fused kernel (K1) -----------------
    x, y = make_batch(9_999, protos)
    x_int = torch.tensor(np.clip(np.round(x / IN_SCALE), -127, 127),
                         dtype=torch.int32, device=dev)
    h, codes, plain = x_int, [], []
    for st in smlp.stages:
        plain.append(ref.threshold_matmul_ref(h, st.w_int, st.thresholds))
        h = ops.threshold_matmul(h, st.w_int, st.thresholds)
        codes.append(h)
    logits = ops.float_head(h, smlp.head_w, smlp.stages[-1].out_scale,
                            smlp.head_b)
    acc_kernel = float((torch.argmax(logits, -1).cpu().numpy() == y).mean())
    with torch.no_grad():
        acc_float = float((torch.argmax(forward(torch.tensor(x, device=dev)),
                                        -1).cpu().numpy() == y).mean())
    say(f"[5] accuracy: float QAT graph {acc_float:.1%} | integer deployment "
        f"on the kernels {acc_kernel:.1%}")

    # --- 6. hardware cost report --------------------------------------------
    cost = ModelCost([dense_cost(f"fc{i}", DIMS[i], DIMS[i + 1], BITS, BITS)
                      for i in range(len(DIMS) - 1)]
                     + [dense_cost("head", DIMS[-1], N_CLASSES, 8, 8)])
    rep = deploy_report(cost, batch=1, bits=BITS)
    say(f"[6] BOPs={cost.bops:.2e}  WM={cost.wm_bits} bits  "
        f"roofline latency={rep['latency_us']:.4f}us ({rep['bound']}-bound)"
        f"  energy={rep['energy_uJ']:.4f}uJ")
    return {"losses": losses, "acc_float": acc_float,
            "acc_kernel": acc_kernel, "stages": smlp.stages, "codes": codes,
            "plain_codes": plain, "report": rep}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()
