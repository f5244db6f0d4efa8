"""Deterministic wave features from static compiled-model structure.

A copy of ``repro.costmodel.features`` over the port's own planners and
cost models. The schema (names, order, ``FEATURE_SCHEMA_VERSION``) is the
reference's, so the reference's artifacts score the port's vectors. On a
staged schedule the vectors are the reference's. Where a megakernel run is
planned, ``log_residency_bytes`` differs: the port prices the run's row
tiles at its per-CTA row tile (``plan.block_m``, 8 rows at admission)
where the reference's plan holds 128 rows. ``megakernel`` and
``log_wave_traffic_bytes`` would differ too wherever the port's admission
(shared memory and L2 budgets) and the reference's (one 2 MiB VMEM cap)
disagree; on the four Table-1 models, at the paper's widths and cut down,
they admit the same runs. ``log_band_bytes`` (and the traffic that
charges a tuned band) reads the ``block_h`` a conv stage holds, which
each package's tuner picks for its own kernel
(``tests/test_torch_costmodel.py``; ``PERF.md`` lists the differences).

Everything here is pure arithmetic over the compiled schedule — no clocks,
no probes, no RNG — so the same model at the same micro-batch always maps
to the same feature vector, on any machine. That determinism is what makes
``REPRO_AUTOTUNE=model`` reproducible and ``build_dataset`` byte-stable.

The schema is versioned: ``FEATURE_SCHEMA_VERSION`` must be bumped whenever
``FEATURE_NAMES`` (names, order, or semantics) changes, and every shipped
predictor artifact records the version it was trained under
(``WaveCostPredictor.from_dict`` refuses a mismatch).

Feature sources mirror the hand-built cost models the predictor is meant to
beat, plus the structural terms they ignore:

- ``log_wave_cycles`` — the analytic FIFO fill/drain cost of one wave
  (``core.dataflow.micro_batch_stage`` summed over stages), the backbone
  the autotuner ranks micro-batches by today;
- Eq. 1 BOPs / schedule traffic / parameter bytes (``core.bops``);
- conv banded-input bytes at the planned ``block_h`` and megakernel
  residency bytes (the tiling/dispatch terms);
- stage/segment counts and widths — the per-wave *dispatch overhead*
  proxies the FIFO model has no term for (the reference's
  ``BENCH_obs.json`` put a +0.7 bias on AD here), which is exactly what a
  model trained on measured waves can learn.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

#: Bump when FEATURE_NAMES (names, order, or semantics) changes. Shipped
#: predictor artifacts record the version they were trained under; loading
#: a mismatched artifact is an error, never a silent misread.
FEATURE_SCHEMA_VERSION = 1

#: Canonical feature order. ``feature_vector`` lays dicts out in exactly
#: this order; predictor artifacts store the list and refuse to score a
#: different one.
FEATURE_NAMES = (
    "log_wave_cycles",        # FIFO fill+drain cycles of one wave at mb
    "log_micro_batch",
    "log_bops",               # Eq. 1 BOPs per sample (whole schedule)
    "log_traffic_bytes",      # per-sample schedule memory traffic
    "log_param_bytes",        # resident weight codes + threshold banks
    "log_band_bytes",         # conv banded-input bytes at planned block_h
    "log_residency_bytes",    # megakernel working set (0 when staged)
    "log_wave_traffic_bytes", # dispatch-mode-aware traffic of one wave
    "n_stages",
    "n_segments",             # host dispatch hops per wave
    "n_conv_stages",
    "n_dense_stages",
    "log_max_width",          # widest stage in/out dim
    "megakernel",             # 1.0 when the wave dispatches fused runs
)


def feature_vector(feats: Dict[str, float]) -> np.ndarray:
    """Lay a feature dict out in ``FEATURE_NAMES`` order.

    Raises ``KeyError`` on a missing feature — a silent zero-fill would
    let a schema drift slip past the predictor unnoticed.
    """
    return np.array([float(feats[name]) for name in FEATURE_NAMES],
                    dtype=np.float64)


def features_from_costs(*, wave_cycles: float, micro_batch: int,
                        bops: float, traffic_bytes: float,
                        param_bytes: float, band_bytes: float = 0.0,
                        residency_bytes: float = 0.0,
                        wave_traffic_bytes: Optional[float] = None,
                        n_stages: int, n_segments: int = 1,
                        n_conv_stages: int = 0, n_dense_stages: int = 0,
                        max_width: float = 1.0,
                        megakernel: bool = False) -> Dict[str, float]:
    """Assemble the schema dict from raw cost numbers.

    The shared low-level constructor: ``wave_features`` feeds it numbers
    measured off a compiled model, ``features_from_model_cost`` feeds it
    numbers from an uncompiled search-space point, and the synthetic
    bootstrap fleet feeds it a grid — all three paths emit the identical
    schema.
    """
    if wave_traffic_bytes is None:
        wave_traffic_bytes = float(micro_batch) * float(traffic_bytes)
    return {
        "log_wave_cycles": math.log1p(max(float(wave_cycles), 0.0)),
        "log_micro_batch": math.log1p(max(int(micro_batch), 1)),
        "log_bops": math.log1p(max(float(bops), 0.0)),
        "log_traffic_bytes": math.log1p(max(float(traffic_bytes), 0.0)),
        "log_param_bytes": math.log1p(max(float(param_bytes), 0.0)),
        "log_band_bytes": math.log1p(max(float(band_bytes), 0.0)),
        "log_residency_bytes": math.log1p(max(float(residency_bytes), 0.0)),
        "log_wave_traffic_bytes": math.log1p(
            max(float(wave_traffic_bytes), 0.0)),
        "n_stages": float(n_stages),
        "n_segments": float(n_segments),
        "n_conv_stages": float(n_conv_stages),
        "n_dense_stages": float(n_dense_stages),
        "log_max_width": math.log1p(max(float(max_width), 1.0)),
        "megakernel": 1.0 if megakernel else 0.0,
    }


def _resolve_segment_mode(cm, segment_mode: Optional[str]) -> str:
    """``None`` means "whatever the compiled model would dispatch"."""
    if segment_mode in ("megakernel", "staged"):
        return segment_mode
    if getattr(cm, "megakernel", False) is False:
        return "staged"
    return "megakernel" if getattr(cm, "_mega_plans", None) else "staged"


def wave_features(cm, micro_batch: int,
                  segment_mode: Optional[str] = None) -> Dict[str, float]:
    """Feature dict for one wave of a ``CompiledTinyModel`` at a micro-batch.

    ``segment_mode`` forces the dispatch flavor the features describe
    ("staged" | "megakernel"); ``None`` follows the model's current mode.
    Forcing "megakernel" re-plans residency from the schedule (independent
    of ``cm.megakernel``) so the autotuner can score both flavors of the
    same model without mutating it.
    """
    from repro_torch.core.bops import (conv_input_band_bytes,
                                       megakernel_residency_bytes,
                                       megakernel_traffic_bytes,
                                       schedule_cost, staged_traffic_bytes)
    from repro_torch.core.dataflow import micro_batch_stage
    from repro_torch.deploy.executor import stage_work
    from repro_torch.deploy.lower import plan_megakernel

    mb = max(int(micro_batch), 1)
    stages = cm.schedule.stages
    mode = _resolve_segment_mode(cm, segment_mode)

    wave_cycles = sum(
        micro_batch_stage(s.name, stage_work(s), mb).latency for s in stages)

    mc = schedule_cost(stages)
    bops, traffic = float(mc.bops), float(mc.traffic_bytes)

    param_bytes = 0.0
    band_bytes = 0.0
    n_conv = n_dense = 0
    max_width = 1.0
    for s in stages:
        max_width = max(max_width, float(getattr(s, "in_dim", 0)),
                        float(getattr(s, "out_dim", 0)))
        bank = getattr(s, "stage", None)       # ThresholdDense, if fused
        if bank is not None:
            param_bytes += float(math.prod(bank.w_int.shape))
            param_bytes += 4.0 * float(math.prod(bank.thresholds.shape))
        w = getattr(s, "w", None)              # FloatHeadStage
        if w is not None:
            param_bytes += 4.0 * float(math.prod(w.shape))
        geom = getattr(s, "geom", None)
        if geom is not None:
            n_conv += 1
            bh = getattr(s, "block_h", None)
            if not bh:
                from repro_torch.kernels.conv_threshold import \
                    plan_conv_blocks

                bh = plan_conv_blocks(geom.out_h, geom.out_w, geom.out_ch)
            band_bytes += conv_input_band_bytes(geom, bh)
        elif bank is not None or w is not None:
            n_dense += 1

    # Dispatch-mode-aware wave traffic: start from the staged per-sample
    # model scaled by the wave, then swap each planned fused run's staged
    # bytes for its residency-aware bytes when scoring the megakernel mode.
    # Plans are recomputed from the schedule so a "megakernel" score never
    # depends on what mode the model object currently happens to be in.
    wave_traffic = float(mb) * traffic
    residency = 0.0
    is_mega = False
    if mode == "megakernel":
        for seg in cm.segments:
            plan = plan_megakernel(
                stages, seg,
                budget_bytes=getattr(cm, "megakernel_budget_bytes", None))
            if plan is None:
                continue
            is_mega = True
            run = stages[plan.start:plan.stop]
            res = megakernel_residency_bytes(run, block_m=plan.block_m)
            residency += float(res["total_bytes"])
            wave_traffic += (megakernel_traffic_bytes(run, mb)
                             - staged_traffic_bytes(run, mb))

    return features_from_costs(
        wave_cycles=wave_cycles, micro_batch=mb, bops=bops,
        traffic_bytes=traffic, param_bytes=param_bytes,
        band_bytes=band_bytes, residency_bytes=residency,
        wave_traffic_bytes=wave_traffic, n_stages=len(stages),
        n_segments=len(cm.segments), n_conv_stages=n_conv,
        n_dense_stages=n_dense, max_width=max_width, megakernel=is_mega)


def features_from_model_cost(mc, micro_batch: int, *, n_segments: int = 1,
                             n_conv_stages: int = 0,
                             megakernel: bool = False) -> Dict[str, float]:
    """Feature dict for an *uncompiled* search-space point.

    Codesign sweeps score quantization × tiling × micro-batch points
    against the predictor without ever compiling or running the
    candidate — the codesign loop at fleet scale. Structural terms the
    ``core.bops.ModelCost`` cannot carry (per-stage widths, band bytes) are
    approximated from layer parameter counts; the approximation is
    monotone in the same quantities the trained features are, which is all
    a *ranking* sweep needs.
    """
    from repro_torch.core.dataflow import micro_batch_stage

    mb = max(int(micro_batch), 1)
    layers = mc.layers
    wave_cycles = sum(
        micro_batch_stage(l.name, max(int(l.flops // 2), 1), mb).latency
        for l in layers)
    param_bytes = float(mc.wm_bits) / 8.0
    traffic = float(mc.traffic_bytes) or param_bytes
    max_width = max((math.sqrt(max(l.n_params, 1)) for l in layers),
                    default=1.0)
    return features_from_costs(
        wave_cycles=wave_cycles, micro_batch=mb, bops=float(mc.bops),
        traffic_bytes=traffic, param_bytes=param_bytes,
        n_stages=len(layers), n_segments=n_segments,
        n_conv_stages=n_conv_stages,
        n_dense_stages=len(layers) - n_conv_stages,
        max_width=max_width, megakernel=megakernel)
