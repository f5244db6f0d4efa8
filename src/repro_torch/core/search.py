"""Hardware-aware NAS: adaptive ASHA + a TPE-style Bayesian-optimization-lite.

A numpy-only copy of ``repro.core.search``: the same drivers, the same
random draws, the same results.

The paper uses (a) KerasTuner Bayesian optimization for the hls4ml IC model
(§3.1.1, Fig. 2) and (b) Determined AI's adaptive ASHA (§3.2.1, Fig. 3) for
the FINN CNV scan and KWS loss-weight search. Both are reimplemented here as
dependency-free drivers over a user-supplied

    objective(config: dict, budget: int, rng) -> float   (higher is better)

ASHA follows Li et al. 2020: rungs at budgets eta^k * r_min; a trial is
promoted to the next rung if it ranks in the top 1/eta of completed trials at
its rung. The implementation is synchronous-in-batches (we have one host) but
keeps ASHA's promotion rule, which is what distinguishes it from plain
successive halving.

BOLite is a kernel-density TPE: observations are split at quantile gamma into
good/bad sets; candidates are sampled from the good-set KDE and scored by the
density ratio l(x)/g(x).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# search space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Choice:
    name: str
    options: Tuple

    def sample(self, rng: np.random.Generator):
        return self.options[int(rng.integers(len(self.options)))]

    def index(self, v) -> int:
        return self.options.index(v)


def sample_config(space: Sequence[Choice], rng: np.random.Generator) -> Dict:
    return {c.name: c.sample(rng) for c in space}


# ---------------------------------------------------------------------------
# ASHA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trial:
    config: Dict
    rung: int = 0
    score: float = -math.inf
    budget_used: int = 0
    alive: bool = True


def asha_search(
    objective: Callable,
    space: Sequence[Choice],
    *,
    n_trials: int = 32,
    r_min: int = 1,
    eta: int = 2,
    max_rung: int = 3,
    seed: int = 0,
) -> Tuple[Trial, List[Trial]]:
    """Adaptive ASHA. Returns (best_trial, all_trials)."""
    rng = np.random.default_rng(seed)
    trials = [Trial(config=sample_config(space, rng)) for _ in range(n_trials)]
    rung_scores: Dict[int, List[float]] = {k: [] for k in range(max_rung + 1)}

    # evaluate every trial at rung 0
    for t in trials:
        t.score = float(objective(t.config, r_min, rng))
        t.budget_used = r_min
        rung_scores[0].append(t.score)

    # promotion loop: a trial at rung k is promoted when it is in the top
    # 1/eta of *completed* rung-k scores (ASHA's asynchronous rule).
    progressed = True
    while progressed:
        progressed = False
        for t in trials:
            if not t.alive or t.rung >= max_rung:
                continue
            scores = rung_scores[t.rung]
            if len(scores) < eta:
                continue
            cutoff = float(np.quantile(np.asarray(scores), 1.0 - 1.0 / eta))
            if t.score >= cutoff:
                t.rung += 1
                budget = r_min * (eta ** t.rung)
                t.score = float(objective(t.config, budget, rng))
                t.budget_used += budget
                rung_scores[t.rung].append(t.score)
                progressed = True
            else:
                t.alive = False  # halted at this rung

    best = max(trials, key=lambda t: (t.rung, t.score))
    return best, trials


# ---------------------------------------------------------------------------
# BO-lite (TPE)
# ---------------------------------------------------------------------------

def _kde_logpdf(x: np.ndarray, samples: np.ndarray, bw: float) -> float:
    if len(samples) == 0:
        return 0.0
    d2 = (x[None, :] - samples) ** 2
    logk = -0.5 * d2.sum(axis=1) / bw ** 2
    return float(np.log(np.exp(logk).mean() + 1e-12))


def bo_search(
    objective: Callable,
    space: Sequence[Choice],
    *,
    n_trials: int = 50,
    n_startup: int = 10,
    gamma: float = 0.25,
    n_candidates: int = 32,
    budget: int = 1,
    seed: int = 0,
) -> Tuple[Dict, List[Tuple[Dict, float]]]:
    """TPE-style BO over a discrete space. Returns (best_config, history)."""
    rng = np.random.default_rng(seed)
    history: List[Tuple[Dict, float]] = []

    def encode(cfg: Dict) -> np.ndarray:
        return np.array(
            [c.index(cfg[c.name]) / max(len(c.options) - 1, 1) for c in space],
            dtype=np.float64,
        )

    for i in range(n_trials):
        if i < n_startup or len(history) < 4:
            cfg = sample_config(space, rng)
        else:
            xs = np.stack([encode(c) for c, _ in history])
            ys = np.array([s for _, s in history])
            cut = np.quantile(ys, 1.0 - gamma)
            good = xs[ys >= cut]
            bad = xs[ys < cut]
            bw = 0.2
            best_cand, best_ratio = None, -math.inf
            for _ in range(n_candidates):
                cand = sample_config(space, rng)
                x = encode(cand)
                ratio = _kde_logpdf(x, good, bw) - _kde_logpdf(x, bad, bw)
                if ratio > best_ratio:
                    best_ratio, best_cand = ratio, cand
            cfg = best_cand
        score = float(objective(cfg, budget, rng))
        history.append((cfg, score))

    best_cfg = max(history, key=lambda t: t[1])[0]
    return best_cfg, history


# ---------------------------------------------------------------------------
# predictor-evaluated codesign sweeps (the fleet-scale mode)
# ---------------------------------------------------------------------------

def predictor_objective(predict_ms: Callable[[Dict], float],
                        feature_fn: Callable[[Dict], Dict]) -> Callable:
    """Wrap a learned wave-cost predictor as a search objective.

    ``feature_fn(config) -> feature dict`` maps a search-space point to
    the versioned ``repro_torch.costmodel`` feature schema (typically via
    ``features_from_model_cost``); the score is the *negative* predicted
    wave cost, so both drivers' higher-is-better convention minimizes
    cost. The objective is pure arithmetic — no compile, no execution, no
    wall clock — which is what lets the quantization x tiling x
    micro-batch scans run thousands of points.
    """

    def objective(config: Dict, budget: int, rng) -> float:
        del budget, rng   # a prediction has no fidelity knob or noise
        return -float(predict_ms(feature_fn(config)))

    return objective


def predictor_sweep(predict_ms: Callable[[Dict], float],
                    feature_fn: Callable[[Dict], Dict],
                    space: Sequence[Choice], *,
                    method: str = "bo", n_trials: int = 64, seed: int = 0,
                    accuracy_fn: Optional[Callable[[Dict], float]] = None
                    ) -> Dict[str, object]:
    """Predictor-evaluated codesign sweep over a discrete space.

    Runs the existing BO/ASHA drivers with ``predictor_objective`` — the
    Fig. 2/3 scans without wall-clock. Returns the best config, every
    evaluated row (config + predicted cost, plus ``accuracy`` when an
    ``accuracy_fn`` surrogate is supplied), and the Pareto-front indices
    over (predicted cost, accuracy).
    """
    obj = predictor_objective(predict_ms, feature_fn)
    if method == "bo":
        best_cfg, history = bo_search(obj, space, n_trials=n_trials,
                                      seed=seed)
        evaluated = [(cfg, score) for cfg, score in history]
    elif method == "asha":
        best, trials = asha_search(obj, space, n_trials=n_trials, seed=seed)
        best_cfg = best.config
        evaluated = [(t.config, t.score) for t in trials]
    else:
        raise ValueError(f"method {method!r}: expected bo|asha")
    rows = []
    for cfg, score in evaluated:
        row = {"config": dict(cfg), "predicted_ms": -float(score)}
        if accuracy_fn is not None:
            row["accuracy"] = float(accuracy_fn(cfg))
        rows.append(row)
    out: Dict[str, object] = {
        "method": method,
        "n_evaluated": len(rows),
        "best": {"config": dict(best_cfg),
                 "predicted_ms": float(predict_ms(feature_fn(best_cfg)))},
        "rows": rows,
    }
    if accuracy_fn is not None:
        pts = [(r["predicted_ms"], r["accuracy"]) for r in rows]
        out["pareto"] = pareto_front(pts)
    return out


# ---------------------------------------------------------------------------
# Pareto utilities (accuracy vs. cost plots of Figs. 2-4)
# ---------------------------------------------------------------------------

def pareto_front(points: Sequence[Tuple[float, float]]) -> List[int]:
    """Indices of the Pareto-optimal set minimizing x (cost), maximizing y
    (accuracy)."""
    idx = sorted(range(len(points)), key=lambda i: (points[i][0], -points[i][1]))
    front, best_y = [], -math.inf
    for i in idx:
        if points[i][1] > best_y:
            front.append(i)
            best_y = points[i][1]
    return front
