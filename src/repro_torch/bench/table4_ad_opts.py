"""Paper Table 4 on the card: the AD model's optimization ladder —
reference (wide, 640-d input, float), + BN folding with 8-bit QAT, + input
downsampling to 128-d, + depth / width reduction (the submitted model) —
with the AUC on the synthetic stand-in after 120 QAT steps each.

The port of ``benchmarks/table4_ad_opts.py``.

    python -m repro_torch.bench.table4_ad_opts [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Dict, List

from repro_torch.bench.common import banner, print_rows, row
from repro_torch.bench.table1_models import train_ad
from repro_torch.data.synthetic import SyntheticMelWindows
from repro_torch.models.tiny import ADAutoencoder

#: name -> (model, input dim, the paper's row)
VARIANTS = {
    "reference_float": (ADAutoencoder(in_dim=640, width=128, bottleneck=8,
                                      weight_bits=32, act_bits=32,
                                      use_bn=True), 640, "87.1% AUC (paper)"),
    "with_folding": (ADAutoencoder(in_dim=640, width=128, bottleneck=8,
                                   weight_bits=8, act_bits=8), 640,
                     "68.1% AUC / 221063 LUT (paper)"),
    "with_downsampling": (ADAutoencoder(in_dim=128, width=128, weight_bits=8,
                                        act_bits=8), 128,
                          "81.4% AUC / 35366 LUT (paper)"),
    "with_all_opt": (ADAutoencoder(in_dim=128, width=72, weight_bits=8,
                                   act_bits=8), 128,
                     "83.3% AUC / 31094 LUT (paper)"),
}


def run(device=None, steps: int = 120) -> List[Dict]:
    banner("Table 4: AD optimization ladder (synthetic AUC + params)")
    rows = []
    for name, (model, dim, paper) in VARIANTS.items():
        r = train_ad(steps, device, model=model,
                     data=SyntheticMelWindows(dim=dim, rank=8, seed=0))
        rows.append(row(
            f"table4/{name}", auc_synthetic=f"{r['quality']:.3f}",
            params=model.n_params(), weight_bits=model.weight_bits,
            final_train_loss=f"{r['losses'][-1]:.4f}", paper_row=paper))
    print_rows(rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)
    run(args.device, args.steps)


if __name__ == "__main__":
    main()
