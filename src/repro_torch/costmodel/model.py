"""Seedable pure-numpy wave-cost predictor with save/load artifacts.

A bagged ridge regressor in log-millisecond space: features are
standardized against the training set, each ensemble member fits a
closed-form L2 solution on a seeded bootstrap resample, and predictions
take the member median — GBM-lite robustness to the outlier waves a serve
trace always contains (GC pauses, first-dispatch compiles) without any new
dependency. Everything is deterministic given ``seed``, so a saved
artifact retrains byte-identically from the same dataset.

Artifacts are plain JSON carrying the feature schema version and the
feature-name list they were trained under; ``WaveCostPredictor.load``
refuses a schema mismatch.

A copy of ``repro.costmodel.model``. The shipped artifact
(``artifacts/default.json``) is the reference's file, byte for byte: it is
fitted to the synthetic bootstrap fleet below (``meta.trained_on =
"bootstrap_rows"``), a grid labelled by a rough analytic cost law, not to
any chip's measured times. ``REPRO_AUTOTUNE=model`` ranks with it until a
fit to the card's own probe records (``dataset.rows_from_tuned_config``)
replaces it through ``REPRO_COSTMODEL_ARTIFACT``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.costmodel.features import (FEATURE_NAMES,
                                            FEATURE_SCHEMA_VERSION,
                                            features_from_costs)

#: Env var pointing at an alternative predictor artifact; the shipped
#: bootstrap-trained default is used when unset.
ARTIFACT_ENV = "REPRO_COSTMODEL_ARTIFACT"

_EPS_MS = 1e-6


def default_artifact_path() -> str:
    """Shipped artifact, overridable via ``REPRO_COSTMODEL_ARTIFACT``. The
    shipped one is fitted to the synthetic bootstrap fleet, not to a
    chip's times."""
    env = os.environ.get(ARTIFACT_ENV, "").strip()
    if env:
        return env
    return os.path.join(os.path.dirname(__file__), "artifacts",
                        "default.json")


@dataclasses.dataclass
class WaveCostPredictor:
    """Bagged ridge over the versioned feature schema, predicting wave ms."""

    feature_names: List[str]
    schema_version: int
    mean: np.ndarray              # (F,) feature standardization
    std: np.ndarray               # (F,)
    weights: np.ndarray           # (members, F + 1); last column is bias
    l2: float
    seed: int
    log_target: bool = True
    meta: Dict = dataclasses.field(default_factory=dict)

    # -- fitting ----------------------------------------------------------

    @classmethod
    def fit(cls, X: np.ndarray, y_ms: np.ndarray, *, l2: float = 1e-2,
            seed: int = 0, n_members: int = 8, subsample: float = 1.0,
            feature_names: Sequence[str] = FEATURE_NAMES,
            meta: Optional[Dict] = None) -> "WaveCostPredictor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y_ms, np.float64)
        if X.ndim != 2 or X.shape[0] != y.shape[0] or X.shape[0] == 0:
            raise ValueError(
                f"bad training shapes X={X.shape} y={y.shape}")
        if X.shape[1] != len(feature_names):
            raise ValueError(
                f"{X.shape[1]} feature columns != "
                f"{len(feature_names)} feature names")
        mean = X.mean(axis=0)
        std = X.std(axis=0)
        std = np.where(std < 1e-12, 1.0, std)
        Z = (X - mean) / std
        t = np.log(np.maximum(y, _EPS_MS))
        n, f = Z.shape
        eye = np.eye(f + 1)
        eye[-1, -1] = 0.0                      # never regularize the bias
        members = []
        k = max(1, int(round(subsample * n)))
        for m in range(max(int(n_members), 1)):
            rng = np.random.default_rng(int(seed) * 100003 + m)
            idx = (rng.integers(0, n, size=k) if n_members > 1
                   else np.arange(n))
            A = np.hstack([Z[idx], np.ones((len(idx), 1))])
            w = np.linalg.solve(A.T @ A + float(l2) * eye, A.T @ t[idx])
            members.append(w)
        return cls(feature_names=list(feature_names),
                   schema_version=FEATURE_SCHEMA_VERSION, mean=mean,
                   std=std, weights=np.stack(members), l2=float(l2),
                   seed=int(seed), meta=dict(meta or {}))

    @classmethod
    def fit_rows(cls, rows: Iterable[Dict], **kw) -> "WaveCostPredictor":
        """Fit from dataset rows ({"features": {...}, "measured_ms": y})."""
        rows = list(rows)
        names = kw.get("feature_names", FEATURE_NAMES)
        X = np.array([[r["features"][k] for k in names] for r in rows],
                     np.float64)
        y = np.array([r["measured_ms"] for r in rows], np.float64)
        return cls.fit(X, y, **kw)

    # -- scoring ----------------------------------------------------------

    def predict_ms(self, feats: Union[Dict[str, float], np.ndarray]
                   ) -> Union[float, np.ndarray]:
        """Predicted wave service milliseconds.

        Accepts one feature dict, one (F,) vector, or an (N, F) matrix;
        scalar in, scalar out.
        """
        if isinstance(feats, dict):
            x = np.array([[float(feats[k]) for k in self.feature_names]],
                         np.float64)
            return float(self._predict(x)[0])
        x = np.asarray(feats, np.float64)
        if x.ndim == 1:
            return float(self._predict(x[None, :])[0])
        return self._predict(x)

    def _predict(self, X: np.ndarray) -> np.ndarray:
        Z = (X - self.mean) / self.std
        A = np.hstack([Z, np.ones((Z.shape[0], 1))])
        per_member = A @ self.weights.T                 # (N, members)
        z = np.median(per_member, axis=1)
        return np.exp(z) if self.log_target else z

    # -- artifacts --------------------------------------------------------

    def to_dict(self) -> Dict:
        return {
            "kind": "ridge_bag",
            "schema_version": int(self.schema_version),
            "feature_names": list(self.feature_names),
            "mean": [float(v) for v in self.mean],
            "std": [float(v) for v in self.std],
            "weights": [[float(v) for v in row] for row in self.weights],
            "l2": float(self.l2),
            "seed": int(self.seed),
            "log_target": bool(self.log_target),
            "meta": self.meta,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "WaveCostPredictor":
        if int(d["schema_version"]) != FEATURE_SCHEMA_VERSION:
            raise ValueError(
                f"predictor artifact schema v{d['schema_version']} != "
                f"feature schema v{FEATURE_SCHEMA_VERSION}; retrain the "
                "artifact (costmodel.model.make_default_artifact)")
        if list(d["feature_names"]) != list(FEATURE_NAMES):
            raise ValueError(
                "predictor artifact feature names do not match "
                "repro_torch.costmodel.features.FEATURE_NAMES")
        return cls(feature_names=list(d["feature_names"]),
                   schema_version=int(d["schema_version"]),
                   mean=np.asarray(d["mean"], np.float64),
                   std=np.asarray(d["std"], np.float64),
                   weights=np.asarray(d["weights"], np.float64),
                   l2=float(d["l2"]), seed=int(d["seed"]),
                   log_target=bool(d.get("log_target", True)),
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=True, indent=1)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: Optional[str] = None) -> "WaveCostPredictor":
        with open(path or default_artifact_path()) as f:
            return cls.from_dict(json.load(f))


def load_default() -> WaveCostPredictor:
    """The shipped (or ``REPRO_COSTMODEL_ARTIFACT``-overridden) predictor.
    The shipped artifact is the bootstrap fleet's fit (``meta.trained_on
    = "bootstrap_rows"``): it ranks by a synthetic cost law, not by any
    chip's measured times."""
    return WaveCostPredictor.load(default_artifact_path())


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def _abs_rel_err(measured: np.ndarray, predicted: np.ndarray) -> np.ndarray:
    # same convention as obs.report.prediction_error: error relative to the
    # *prediction*, so the learned and analytic columns compare one-to-one
    # with the BENCH_obs.json baseline
    return np.abs(measured - predicted) / np.maximum(predicted, _EPS_MS)


def leave_one_model_out(rows: Sequence[Dict], **fit_kw) -> Dict[str, Dict]:
    """LOMO validation: hold out each model family, train on the rest.

    Rows are dataset rows (``dataset.Dataset.rows``). Returns per-held-out
    model ``median_abs_rel_err`` / ``mean_abs_rel_err`` for the learned
    predictor and — where rows carry the analytic FIFO prediction
    (``analytic_ms``) — the same stats for the hand-built baseline, plus a
    pooled "overall" entry. The acceptance bar is learned ≤ analytic on
    the pooled median: the learned model must beat the cost model it was
    bootstrapped from.
    """
    rows = list(rows)
    models = sorted({r["model"] for r in rows})
    out: Dict[str, Dict] = {}
    pooled_learned: List[float] = []
    pooled_analytic: List[float] = []
    for held in models:
        train = [r for r in rows if r["model"] != held]
        test = [r for r in rows if r["model"] == held]
        if not train or not test:
            continue
        pred = WaveCostPredictor.fit_rows(train, **fit_kw)
        names = pred.feature_names
        X = np.array([[r["features"][k] for k in names] for r in test])
        meas = np.array([r["measured_ms"] for r in test], np.float64)
        learned = _abs_rel_err(meas, np.asarray(pred.predict_ms(X)))
        entry = {
            "n": len(test),
            "median_abs_rel_err": float(np.median(learned)),
            "mean_abs_rel_err": float(np.mean(learned)),
        }
        pooled_learned.extend(learned.tolist())
        analytic_pairs = [(r["measured_ms"], r["analytic_ms"])
                          for r in test if r.get("analytic_ms") is not None]
        if analytic_pairs:
            am = np.array([p[0] for p in analytic_pairs], np.float64)
            ap = np.array([p[1] for p in analytic_pairs], np.float64)
            analytic = _abs_rel_err(am, ap)
            entry["analytic_median_abs_rel_err"] = float(np.median(analytic))
            entry["analytic_mean_abs_rel_err"] = float(np.mean(analytic))
            pooled_analytic.extend(analytic.tolist())
        out[held] = entry
    overall: Dict[str, float] = {"n": len(pooled_learned)}
    if pooled_learned:
        overall["median_abs_rel_err"] = float(np.median(pooled_learned))
        overall["mean_abs_rel_err"] = float(np.mean(pooled_learned))
    if pooled_analytic:
        overall["analytic_median_abs_rel_err"] = float(
            np.median(pooled_analytic))
        overall["analytic_mean_abs_rel_err"] = float(
            np.mean(pooled_analytic))
    out["overall"] = overall
    return out


# ---------------------------------------------------------------------------
# bootstrap fleet — the synthetic prior behind the shipped default artifact
# ---------------------------------------------------------------------------

#: Synthetic cost law the bootstrap fleet is labeled with: CPU-flavored
#: seconds-per-FIFO-cycle, per-segment host dispatch overhead, and a
#: per-byte traffic term. The *constants* are rough; what matters is that
#: the shipped prior already knows "cycles + dispatch hops + bytes" so a
#: cold fleet gets sane rankings before any measured rows arrive, and
#: retraining on real traces only sharpens it.
BOOTSTRAP_SEC_PER_CYCLE = 2e-9
BOOTSTRAP_SEC_PER_SEGMENT = 8e-5
BOOTSTRAP_SEC_PER_BYTE = 2e-10


def bootstrap_rows(seed: int = 0) -> List[Dict]:
    """Deterministic synthetic fleet: a grid of MLP/conv-ish structures ×
    micro-batches, labeled by the analytic cost law above. No RNG, no
    clocks — the same rows on every machine, so the committed default
    artifact is reproducible from source."""
    del seed  # grid is fully deterministic; kept for signature stability
    rows: List[Dict] = []
    widths = (16, 64, 256, 512)
    depths = (2, 4, 8)
    micro_batches = (1, 4, 16, 64)
    for w in widths:
        for d in depths:
            for mb in micro_batches:
                for n_seg in (1, 2):
                    for mega in (False, True):
                        work = w * w
                        # mirror core.dataflow.micro_batch_stage's law
                        cyc = d * (8 + max(1, math.ceil(work * mb / 8192)))
                        params = float(d * (w * w + 4 * w * 3))
                        traffic = params + 4.0 * 2 * w * d
                        residency = params if mega else 0.0
                        wave_traffic = (params + 4.0 * mb * 2 * w if mega
                                        else mb * traffic)
                        # cycles + host hops + per-program launches + bytes
                        sec = (cyc * BOOTSTRAP_SEC_PER_CYCLE
                               + n_seg * BOOTSTRAP_SEC_PER_SEGMENT
                               + (n_seg if mega else d) * 0.25
                               * BOOTSTRAP_SEC_PER_SEGMENT
                               + wave_traffic * BOOTSTRAP_SEC_PER_BYTE)
                        feats = features_from_costs(
                            wave_cycles=cyc, micro_batch=mb,
                            bops=64.0 * work * d, traffic_bytes=traffic,
                            param_bytes=params, residency_bytes=residency,
                            wave_traffic_bytes=wave_traffic, n_stages=d,
                            n_segments=n_seg, n_dense_stages=d,
                            max_width=w, megakernel=mega)
                        rows.append({
                            "model": f"boot_w{w}_d{d}_s{n_seg}",
                            "platform": "bootstrap",
                            "source": "bootstrap",
                            "micro_batch": mb,
                            "segment_mode": ("megakernel" if mega
                                             else "staged"),
                            "measured_ms": sec * 1e3,
                            "analytic_ms": None,
                            "features": feats,
                        })
    return rows


def make_default_artifact(path: Optional[str] = None) -> str:
    """(Re)train the shipped default artifact from the bootstrap fleet."""
    target = path or os.path.join(os.path.dirname(__file__), "artifacts",
                                  "default.json")
    pred = WaveCostPredictor.fit_rows(
        bootstrap_rows(), l2=1e-2, seed=0, n_members=8,
        meta={"trained_on": "bootstrap_rows", "n_rows": len(bootstrap_rows())})
    return pred.save(target)
