"""Span-derived reports: latency percentiles recomputed from the trace and
the predicted-vs-measured service-time trail. A copy of
``repro.obs.report`` over the port's tracer.

Two consumers drive the shapes here:

  * **Cross-checking** — the serve stack's sliding-window metrics
    (``serve.metrics``) and the trace record the same completions through
    different paths; ``latency_percentiles`` recomputes p50/p90/p99 from
    request spans with the *same arithmetic* (same floats, same
    ``np.percentile``), so under a ``ManualClock`` the two must agree to
    the bit — the consistency test that keeps instrumentation honest.
  * **The learned cost model** — every dispatch span carries
    the FIFO-cost-model *predicted* wave service time next to its measured
    duration; ``prediction_error`` aggregates the error statistics per
    (model, platform). That table is the raw training set for a learned
    service-time predictor: accumulate it across bench runs and you have
    predicted-vs-measured pairs for every wave the server ever ran.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.tracer import Tracer

#: Span names the serve instrumentation records (single source of truth —
#: the router and these reports must agree on them).
REQUEST_SPAN = "request"
WAVE_SPAN = "wave"
STAGE_SPAN = "stage"


def request_latencies_ms(tracer: Tracer, model: Optional[str] = None
                         ) -> np.ndarray:
    """Per-request latency (ms) from request spans, shed requests excluded
    — the same population ``ServeMetrics`` aggregates."""
    lats = []
    for e in tracer.spans(name=REQUEST_SPAN):
        a = e.args or {}
        if a.get("shed"):
            continue
        if model is not None and a.get("model") != model:
            continue
        lats.append((e.t1 - e.t0) * 1e3)
    return np.asarray(lats)


def latency_percentiles(tracer: Tracer, model: Optional[str] = None
                        ) -> Dict[str, float]:
    """p50/p90/p99 (ms) recomputed from request spans with the exact
    arithmetic of ``ServeMetrics.snapshot`` — same floats in, same
    ``np.percentile`` call, bit-identical out (tested)."""
    lats = request_latencies_ms(tracer, model)
    if lats.size == 0:
        return {"n": 0, "p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0}
    p50, p90, p99 = (float(np.percentile(lats, q)) for q in (50, 90, 99))
    return {"n": int(lats.size), "p50_ms": p50, "p90_ms": p90, "p99_ms": p99}


def prediction_records(tracer: Tracer) -> List[Dict]:
    """Flat (model, platform, micro_batch, n_valid, predicted_ms,
    measured_ms) rows from wave spans — the learned-cost-model training
    set, one row per dispatched wave."""
    rows = []
    for e in tracer.spans(name=WAVE_SPAN):
        a = e.args or {}
        if a.get("predicted_ms") is None:
            continue
        rows.append({
            "model": a.get("model", ""),
            "platform": a.get("platform", ""),
            "micro_batch": a.get("micro_batch"),
            "n_valid": a.get("n_valid"),
            "predicted_ms": float(a["predicted_ms"]),
            "measured_ms": (e.t1 - e.t0) * 1e3,
        })
    return rows


def export_prediction_records(tracer: Tracer, path: str) -> str:
    """Write ``prediction_records`` as a deterministic JSONL shard.

    One sorted-key JSON object per line, rows in span order — the
    accumulable on-disk form ``repro_torch.costmodel.dataset`` harvests
    (``load_trace_records``): archive a shard per traced run and the
    training table rebuilds byte-identically from the archive alone.
    """
    import json
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for r in prediction_records(tracer):
            f.write(json.dumps(r, sort_keys=True, separators=(",", ":")))
            f.write("\n")
    return path


def prediction_error(tracer: Tracer) -> Dict[str, Dict]:
    """Prediction-error statistics per ``model@platform``.

    Per group: wave count, mean/median absolute relative error
    (|measured - predicted| / predicted), and the signed bias
    (mean (measured - predicted) / predicted — positive means the FIFO
    model is optimistic, the usual case when dispatch overhead is
    uncalibrated). This is the table ``BENCH_obs.json`` publishes and the
    number a learned predictor has to beat.
    """
    groups: Dict[str, List[Dict]] = {}
    for r in prediction_records(tracer):
        groups.setdefault(f"{r['model']}@{r['platform']}", []).append(r)
    out: Dict[str, Dict] = {}
    for key, rows in sorted(groups.items()):
        pred = np.asarray([r["predicted_ms"] for r in rows])
        meas = np.asarray([r["measured_ms"] for r in rows])
        rel = (meas - pred) / np.maximum(pred, 1e-12)
        out[key] = {
            "n_waves": len(rows),
            "predicted_ms_mean": float(pred.mean()),
            "measured_ms_mean": float(meas.mean()),
            "mean_abs_rel_err": float(np.abs(rel).mean()),
            "median_abs_rel_err": float(np.median(np.abs(rel))),
            "bias_rel": float(rel.mean()),
        }
    return out


def stage_medians_ms(tracer: Tracer) -> Dict[str, float]:
    """Median duration (ms) per stage from ``stage`` probe spans — the
    span-derived form of ``CompiledTinyModel.stage_latencies``, used to
    cross-check the returned breakdown against the trace."""
    per: Dict[str, List[float]] = {}
    for e in tracer.spans(name=STAGE_SPAN):
        a = e.args or {}
        per.setdefault(str(a.get("stage", "?")), []).append(e.t1 - e.t0)
    out = {}
    for name, ts in per.items():
        ts.sort()
        out[name] = ts[len(ts) // 2] * 1e3
    return out
