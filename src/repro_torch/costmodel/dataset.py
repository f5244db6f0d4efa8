"""Reproducible training table from the measurement exhaust of the stack.

A copy of ``repro.costmodel.dataset``; the port's resolver extracts the
port's ``wave_features``, and its probe records (``TunedConfig`` audit
trails on the card) are the rows a fit to the card's own times reads.

Three harvest sources, all things the repo already emits:

- ``obs.report.prediction_records`` traces — per-wave (predicted, measured)
  service times from any traced server run (the richest source; also
  carries the analytic FIFO prediction as the baseline column);
- ``TunedConfig`` audit trails — every measured probe the autotuner paid
  for (micro-batch candidates, the block_mn refinement probe, the
  megakernel-vs-staged probe) becomes a labeled row instead of being
  thrown away;
- accumulated ``BENCH_*.json`` — the per-model wave-service anchors the
  serving benchmark publishes.

Rows join a target (measured per-wave milliseconds) with the versioned
feature schema via a caller-supplied resolver ``features_for(model,
platform, micro_batch, segment_mode) -> dict | None`` (``None`` skips the
row — e.g. a trace naming a model this process has not compiled).

Determinism contract: ``Dataset.to_json_str`` sorts rows by a total key
and serializes with fixed separators + sorted keys, so the same input
records — in any order — produce a byte-identical on-disk table. That is
what makes a retrained predictor artifact reproducible from archived CI
artifacts alone.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.costmodel.features import FEATURE_NAMES, FEATURE_SCHEMA_VERSION

DATASET_SCHEMA_VERSION = 1

#: features_for(model, platform, micro_batch, segment_mode) -> feats | None
FeatureResolver = Callable[[str, str, int, Optional[str]],
                           Optional[Dict[str, float]]]


def _row(model: str, platform: str, source: str, micro_batch: int,
         segment_mode: Optional[str], measured_ms: float,
         analytic_ms: Optional[float],
         feats: Dict[str, float]) -> Dict:
    return {
        "model": str(model),
        "platform": str(platform),
        "source": str(source),
        "micro_batch": int(micro_batch),
        "segment_mode": segment_mode,
        "measured_ms": float(measured_ms),
        "analytic_ms": None if analytic_ms is None else float(analytic_ms),
        "features": {k: float(feats[k]) for k in FEATURE_NAMES},
    }


def rows_from_trace_records(records: Iterable[Dict],
                            features_for: FeatureResolver) -> List[Dict]:
    """Rows from ``obs.report.prediction_records`` output (or its JSONL
    export): one labeled wave per record, analytic FIFO prediction kept as
    the baseline column."""
    rows = []
    for r in records:
        measured = float(r.get("measured_ms") or 0.0)
        if measured <= 0.0:
            continue
        mb = int(r.get("micro_batch") or 0)
        if mb <= 0:
            continue
        feats = features_for(r["model"], r.get("platform", "cpu"), mb,
                             r.get("segment_mode"))
        if feats is None:
            continue
        rows.append(_row(r["model"], r.get("platform", "cpu"), "trace", mb,
                         r.get("segment_mode"), measured,
                         r.get("predicted_ms"), feats))
    return rows


def _config_model_name(cfg: Dict) -> str:
    # TunedConfig.key is "<Model>-<platform>-<schedule digest>"; the port's
    # platform holds dashes itself ("torch-cpu", "torch-cuda-<card>"), so
    # the config's own platform is cut off first
    key = str(cfg.get("key", ""))
    cut = f"-{cfg.get('platform', '')}-"
    if cfg.get("platform") and cut in key:
        return key[:key.rindex(cut)]
    parts = key.rsplit("-", 2)
    return parts[0] if len(parts) == 3 else key


def rows_from_tuned_config(cfg, features_for: FeatureResolver) -> List[Dict]:
    """Rows from one ``TunedConfig`` audit trail (dataclass or dict).

    Every measured probe becomes a row: micro-batch candidates
    (``probe_ms`` over ``n_micro`` waves), the megakernel-vs-staged probe,
    and the block_mn refinement probe. Model-mode configs contribute
    nothing — their candidates carry predictions, not measurements.
    """
    if hasattr(cfg, "to_dict"):
        cfg = cfg.to_dict()
    model = _config_model_name(cfg)
    platform = str(cfg.get("platform", "cpu"))
    mode = cfg.get("segment_mode") or "staged"
    rows = []
    for cand in cfg.get("candidates") or []:
        probe = cand.get("probe_ms")
        n_micro = int(cand.get("n_micro") or 0)
        mb = int(cand.get("micro_batch") or 0)
        if probe is None or n_micro <= 0 or mb <= 0:
            continue
        feats = features_for(model, platform, mb, mode)
        if feats is None:
            continue
        rows.append(_row(model, platform, "autotune", mb, mode,
                         float(probe) / n_micro, None, feats))
    seg = cfg.get("segment_mode_model") or {}
    seg_probe = seg.get("probe_ms") or {}
    n_micro = int(seg.get("n_micro") or 0)
    wave = int(seg.get("wave_rows") or cfg.get("micro_batch") or 0)
    if n_micro > 0 and wave > 0:
        for seg_mode, ms in sorted(seg_probe.items()):
            if ms is None:
                continue
            feats = features_for(model, platform, wave, seg_mode)
            if feats is None:
                continue
            rows.append(_row(model, platform, "autotune", wave, seg_mode,
                             float(ms) / n_micro, None, feats))
    blk = cfg.get("block_mn_probe") or {}
    blk_probe = blk.get("probe_ms") or {}
    n_micro = int(blk.get("n_micro") or 0)
    wave = int(blk.get("wave_rows") or 0)
    if n_micro > 0 and wave > 0:
        for pick, ms in sorted(blk_probe.items()):
            if ms is None:
                continue
            feats = features_for(model, platform, wave, mode)
            if feats is None:
                continue
            rows.append(_row(model, platform, "autotune", wave, mode,
                             float(ms) / n_micro, None, feats))
    return rows


def rows_from_bench_doc(doc: Dict,
                        features_for: FeatureResolver) -> List[Dict]:
    """Rows from an accumulated ``BENCH_*.json`` document.

    Currently understands the serving benchmark's per-model anchors
    (``doc["models"][name]["wave_service_ms" | "micro_batch"]``); other
    documents contribute nothing rather than erroring, so a whole
    artifact directory can be fed in unfiltered.
    """
    rows = []
    platform = str(doc.get("provenance", {}).get("backend",
                                                 doc.get("backend", "cpu")))
    for name, entry in sorted((doc.get("models") or {}).items()):
        if not isinstance(entry, dict):
            continue
        ms = entry.get("wave_service_ms")
        mb = int(entry.get("micro_batch") or 0)
        if ms is None or float(ms) <= 0.0 or mb <= 0:
            continue
        feats = features_for(name, platform, mb, entry.get("segment_mode"))
        if feats is None:
            continue
        rows.append(_row(name, platform, "bench", mb,
                         entry.get("segment_mode"), float(ms), None, feats))
    return rows


def load_trace_records(path: str) -> List[Dict]:
    """Read a JSONL shard written by ``obs.report.export_prediction_records``."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


@dataclasses.dataclass
class Dataset:
    """The on-disk training table: versioned features joined with targets."""

    rows: List[Dict]
    feature_names: Tuple[str, ...] = FEATURE_NAMES
    schema_version: int = FEATURE_SCHEMA_VERSION

    def __post_init__(self):
        self.rows = sorted(self.rows, key=_sort_key)

    def X(self) -> np.ndarray:
        return np.array([[r["features"][k] for k in self.feature_names]
                         for r in self.rows], np.float64)

    def y_ms(self) -> np.ndarray:
        return np.array([r["measured_ms"] for r in self.rows], np.float64)

    def models(self) -> List[str]:
        return sorted({r["model"] for r in self.rows})

    def to_json_str(self) -> str:
        doc = {
            "dataset_schema_version": DATASET_SCHEMA_VERSION,
            "feature_schema_version": int(self.schema_version),
            "feature_names": list(self.feature_names),
            "n_rows": len(self.rows),
            "rows": self.rows,
        }
        return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json_str())
        return path

    @classmethod
    def load(cls, path: str) -> "Dataset":
        with open(path) as f:
            doc = json.load(f)
        if int(doc["feature_schema_version"]) != FEATURE_SCHEMA_VERSION:
            raise ValueError(
                f"dataset feature schema v{doc['feature_schema_version']} "
                f"!= v{FEATURE_SCHEMA_VERSION}; rebuild the table")
        return cls(rows=doc["rows"],
                   feature_names=tuple(doc["feature_names"]),
                   schema_version=int(doc["feature_schema_version"]))


def _sort_key(r: Dict):
    return (r["model"], r["platform"], r["source"], r["micro_batch"],
            r["segment_mode"] or "", r["measured_ms"],
            -1.0 if r["analytic_ms"] is None else r["analytic_ms"])


def build_dataset(features_for: FeatureResolver, *,
                  trace_records: Iterable[Dict] = (),
                  tuned_configs: Iterable = (),
                  bench_docs: Iterable[Dict] = ()) -> Dataset:
    """Join all three harvest sources into one deterministic table."""
    rows: List[Dict] = []
    rows.extend(rows_from_trace_records(trace_records, features_for))
    for cfg in tuned_configs:
        rows.extend(rows_from_tuned_config(cfg, features_for))
    for doc in bench_docs:
        rows.extend(rows_from_bench_doc(doc, features_for))
    return Dataset(rows=rows)


def compiled_feature_resolver(models: Dict[str, object]) -> FeatureResolver:
    """The standard resolver: look the model name up in a dict of
    ``CompiledTinyModel``s and extract ``wave_features``. Unknown names
    resolve to ``None`` (row skipped) so traces mentioning models this
    process never compiled are harvested gracefully."""
    from repro_torch.costmodel.features import wave_features

    def resolve(model: str, platform: str, micro_batch: int,
                segment_mode: Optional[str]) -> Optional[Dict[str, float]]:
        cm = models.get(model)
        if cm is None:
            return None
        return wave_features(cm, micro_batch, segment_mode)

    return resolve
