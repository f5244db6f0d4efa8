"""Paper Fig. 4 on the card: quantization exploration for KWS — a QAT
training run at each bit width on the synthetic MFCC stand-in, validation
accuracy against BOPs.

The port of ``benchmarks/fig4_quant_scan.py``: a small KWS MLP of the
same structure (64 inputs, width 48) trained 160 steps at W/A 32 (the
float baseline), 8, 6, 4, 3, 2 and 1 bits. The paper's finding to
reproduce qualitatively: accuracy holds from FP32 down to about 3 bits and
falls below, while BOPs shrink superlinearly.

    python -m repro_torch.bench.fig4_quant_scan [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

from repro_torch.bench.common import banner, print_rows, row
from repro_torch.bench.table1_models import train_kws
from repro_torch.models.tiny import KWSMLP

BITS = (32, 8, 6, 4, 3, 2, 1)


def train_at_bits(bits: int, device=None, steps: int = 160, dim: int = 64,
                  width: int = 48) -> Tuple[float, float]:
    """(accuracy on 500 balanced samples, BOPs) of a KWS MLP trained with
    QAT at ``bits`` for weights and activations (32: float)."""
    model = KWSMLP(in_dim=dim, width=width, weight_bits=bits, act_bits=bits)
    r = train_kws(steps, device, seed=bits, model=model)
    return r["quality"], model.cost().bops


def run(device=None, steps: int = 160) -> List[Dict]:
    banner("Fig 4: KWS quantization exploration (REAL QAT at each width)")
    rows, results = [], {}
    for bits in BITS:
        acc, bops = train_at_bits(bits, device, steps)
        results[bits] = acc
        rows.append(row(
            f"fig4/W{bits}A{bits}", accuracy=f"{acc:.3f}",
            bops=f"{bops:.3e}",
            paper_point=("FP32 ref" if bits == 32 else
                         "chosen (3-bit)" if bits == 3 else "")))
    cliff = results[3] - results[2]
    hold = results[32] - results[3]
    rows.append(row(
        "fig4/summary", acc_drop_fp32_to_3bit=f"{hold:.3f}",
        acc_drop_3bit_to_2bit=f"{cliff:.3f}",
        cliff_below_3_bits=bool(cliff > hold),
        paper_finding="accuracy holds to 3 bits, drops sharply below"))
    print_rows(rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=160)
    args = ap.parse_args(argv)
    run(args.device, args.steps)


if __name__ == "__main__":
    main()
