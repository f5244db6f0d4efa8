"""Paper Fig. 3: adaptive-ASHA scan of CNV variants in the (inference cost C,
accuracy) plane, with Eq. 2's cost normalized to the CNV-W1A1 reference.

Cost C is computed with the REAL BOPs/WM model (Eqs. 1-2); the accuracy axis
is the same calibrated surrogate family as fig2 (dataset offline). The
paper's finding to reproduce: CNV-W1A1 (C=1) sits essentially on the front.

The port of ``benchmarks/fig3_asha_scan.py`` over the port's ``core.bops``,
``core.search`` and ``costmodel`` (the shipped predictor): numpy only, no
device work, the same rows as the reference.

    python -m repro_torch.bench.fig3_asha_scan
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.bench.common import banner, print_rows, row
from repro_torch.core.bops import ModelCost, conv_cost, dense_cost
from repro_torch.core.search import Choice, asha_search, pareto_front, \
    predictor_sweep
from repro_torch.costmodel import features_from_model_cost, load_default


def cnv_cost(channels_scale, fc_units, w_bits, a_bits) -> ModelCost:
    chans = [int(64 * channels_scale), int(64 * channels_scale),
             int(128 * channels_scale), int(128 * channels_scale),
             int(256 * channels_scale), int(256 * channels_scale)]
    layers, cin, hw = [], 3, 32
    for i, ch in enumerate(chans):
        hw -= 2
        layers.append(conv_cost(f"c{i}", cin, max(ch, 1), 3, hw, hw,
                                8 if i == 0 else a_bits, w_bits, bias=False))
        if i in (1, 3):
            hw //= 2
        cin = max(ch, 1)
    dims = [cin, fc_units, fc_units, 10]
    for i in range(3):
        layers.append(dense_cost(f"f{i}", dims[i], dims[i + 1], a_bits,
                                 w_bits, bias=False))
    return ModelCost(layers)


REF = cnv_cost(1.0, 512, 1, 1)     # CNV-W1A1


def surrogate_accuracy(cfg, budget, rng):
    scale, fc, wb, ab = (cfg["scale"], cfg["fc"], cfg["w_bits"], cfg["a_bits"])
    acc = 0.86
    acc -= 0.10 * math.exp(-scale * 2.2)
    acc -= 0.05 * math.exp(-fc / 120.0)
    acc += 0.012 * (wb - 1) + 0.012 * (ab - 1)     # 2-bit slightly better
    return acc + rng.normal(0, 0.03 / math.sqrt(budget))


def run():
    banner("Fig 3: ASHA scan of CNV variants (accuracy x inference cost C)")
    space = [
        Choice("scale", (0.25, 0.5, 1.0, 2.0)),
        Choice("fc", (16, 64, 128, 256, 512)),
        Choice("w_bits", (1, 2)),
        Choice("a_bits", (1, 2)),
    ]
    best, trials = asha_search(surrogate_accuracy, space, n_trials=48,
                               r_min=1, eta=2, max_rung=4, seed=0)
    pts = []
    for t in trials:
        c = cnv_cost(t.config["scale"], t.config["fc"], t.config["w_bits"],
                     t.config["a_bits"]).cost_vs(REF)
        pts.append((c, t.score))
    front = pareto_front(pts)

    # where does CNV-W1A1 (cost exactly 1.0) sit relative to the front?
    rng = np.random.default_rng(0)
    cnv_acc = surrogate_accuracy({"scale": 1.0, "fc": 512, "w_bits": 1,
                                  "a_bits": 1}, 16, rng)
    dominators = [p for p in pts if p[0] <= 1.0 and p[1] > cnv_acc + 0.01]

    rows = [row(
        "fig3/asha_scan",
        n_trials=len(trials),
        total_budget=sum(t.budget_used for t in trials),
        best_score=f"{best.score:.3f}",
        best_cost_C=f"{cnv_cost(best.config['scale'], best.config['fc'], best.config['w_bits'], best.config['a_bits']).cost_vs(REF):.2f}",
        pareto_points=len(front),
        cnv_w1a1_cost=1.0,
        cnv_near_optimal=(len(dominators) <= 3),
        paper_finding="CNV-W1A1 performs near optimally",
    )]

    # -- predictor-evaluated codesign sweep: quantization x architecture x
    # serving micro-batch, ranked by the learned wave-cost predictor — the
    # Fig. 3 scan re-run without wall-clock. ASHA's
    # rungs degenerate to one evaluation each (predictions are exact), but
    # the promotion bookkeeping is exercised on the predictor objective.
    predictor = load_default()
    codesign_space = space + [Choice("micro_batch", (1, 4, 16, 64))]

    def feature_fn(cfg):
        mc = cnv_cost(cfg["scale"], cfg["fc"], cfg["w_bits"], cfg["a_bits"])
        return features_from_model_cost(mc, cfg["micro_batch"],
                                        n_conv_stages=6)

    sweep = predictor_sweep(
        predictor.predict_ms, feature_fn, codesign_space, method="asha",
        n_trials=64, seed=0,
        accuracy_fn=lambda cfg: surrogate_accuracy(
            cfg, 10**8, np.random.default_rng(0)))
    best_pred = sweep["best"]
    rows.append(row(
        "fig3/predictor_codesign_sweep",
        n_evaluated=sweep["n_evaluated"],
        best_cfg=(f"x{best_pred['config']['scale']}"
                  f"fc{best_pred['config']['fc']}"
                  f"w{best_pred['config']['w_bits']}"
                  f"a{best_pred['config']['a_bits']}"
                  f"mb{best_pred['config']['micro_batch']}"),
        best_predicted_ms=f"{best_pred['predicted_ms']:.3f}",
        pareto_points=len(sweep["pareto"]),
        note="learned-cost sweep, zero wall-clock evaluations"))
    print_rows(rows)
    return rows


if __name__ == "__main__":
    run()
