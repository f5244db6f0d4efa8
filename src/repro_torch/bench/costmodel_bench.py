"""Cost-model bench of the port: the learned wave-cost predictor's
leave-one-model-out error against the analytic FIFO model, and probe-mode
against model-mode autotune agreement, on the card.

    python -m repro_torch.bench.costmodel_bench [--device cuda]

The port of ``benchmarks/costmodel_bench.py``:

  1. **Harvest.** Traced ``server_streaming`` runs of each family at
     several wave sizes record every dispatched wave's measured service
     beside the analytic FIFO prediction (``obs.report.prediction_records``);
     a probe-mode autotune of each family adds its audit trail's probes.
     ``costmodel.dataset`` joins both into the training table (saved beside
     the artifacts with the raw JSONL shards).
  2. **Leave one model out.** Each family is held out in turn, the
     predictor trained on the rest and scored on it. Asserted: the pooled
     median absolute relative error of the learned predictor is at most the
     analytic FIFO model's on the same waves.
  3. **Agreement.** Each family is tuned twice, in probe mode and in model
     mode (the predictor fitted to the whole table). Where the picks (micro
     batch, segment mode) match, agreement holds by construction; where
     they differ, both configs are probed (``probe_streaming``) and the
     predicted one must hold at least ``MIN_AGREEMENT_TPUT`` (90%) of the
     probed one's throughput (asserted).

Every section runs and is reported first; then ``run`` asserts both bars
(``bar_failures``), after the numbers are printed and written to
``BENCH_torch_costmodel.json`` (``REPRO_BENCH_DIR``).
``REPRO_FAST=1`` runs KWS and AD with fewer queries; the full pass adds IC
and CNV.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import List

from repro_torch.bench.common import (banner, bench_dir, emit_json,
                                      print_rows, require, row)
from repro_torch.bench import table6_scenarios
from repro_torch.costmodel import (WaveCostPredictor, build_dataset,
                                   compiled_feature_resolver,
                                   leave_one_model_out)
from repro_torch.deploy.autotune import (autotune_model, default_sample,
                                         load_config, probe_streaming,
                                         schedule_key)
from repro_torch.deploy.scenarios import server_streaming
from repro_torch.obs import Tracer, export_prediction_records
from repro_torch.obs.report import prediction_records
from repro_torch.serve import ServiceModel, measure_wave_service_s

FAST = os.environ.get("REPRO_FAST", "0") not in ("0", "")

#: Throughput the predicted config must hold against the probed config
#: where the two disagree (asserted).
MIN_AGREEMENT_TPUT = 0.9

#: The predictor's fit, as the reference bench fits it.
FIT = {"l2": 1e-2, "seed": 0, "n_members": 8}


def build_entries(device=None, fast: bool = FAST, seed: int = 0):
    """name -> (compiled model, query maker): KWS and AD, and IC and CNV
    unless ``fast``, at full width on ``device``
    (``table6_scenarios.build_entries``)."""
    names = (("KWS-FINN", "AD-hls4ml") if fast
             else tuple(table6_scenarios.MODELS))
    return {name: (cm, mk) for name, (cm, mk, _) in
            table6_scenarios.build_entries(names, device=device,
                                           seed=seed).items()}


def _traced_records(name, cm, mk, micro_batch, n_queries):
    """One traced router run at a forced wave size: its wave rows, tagged
    with the family's name (the router registers every model under one
    lane key), and the tracer."""
    tracer = Tracer()
    cm.set_tracer(tracer)
    service = ServiceModel.from_compiled(cm, probe_batch=8)
    service = service.recalibrated(
        measure_wave_service_s(cm, micro_batch), micro_batch)
    try:
        server_streaming(
            cm, mk, qps=0.7 * service.saturation_qps(micro_batch),
            n_queries=n_queries, seed=7,
            max_wait_ms=max(2.0, 1.5 * service.wave_service_s(micro_batch)
                            * 1e3),
            micro_batch=micro_batch, service_model=service, tracer=tracer)
    finally:
        cm.set_tracer(None)
    records = [{**r, "model": name, "micro_batch": micro_batch}
               for r in prediction_records(tracer)]
    return records, tracer


def lomo_section(rows):
    """Leave one model out over the table's ``rows`` with the bench's fit;
    returns the summary and its printable rows."""
    lomo = leave_one_model_out(rows, **FIT)
    out = []
    for held, stats in sorted(lomo.items()):
        if held == "overall":
            continue
        out.append(row(
            f"costmodel/{held}/lomo", 0.0, n=stats["n"],
            learned_med=f"{stats['median_abs_rel_err']:.3f}",
            analytic_med=(f"{stats['analytic_median_abs_rel_err']:.3f}"
                          if "analytic_median_abs_rel_err" in stats
                          else "-")))
    overall = lomo["overall"]
    out.append(row(
        "costmodel/overall/lomo", 0.0, n=overall["n"],
        learned_med=f"{overall['median_abs_rel_err']:.3f}",
        analytic_med=f"{overall['analytic_median_abs_rel_err']:.3f}"))
    return lomo, out


def bar_failures(doc) -> List[str]:
    """The bench's two bars over its payload: the learned pooled median
    error at most the analytic one's (LOMO), and every family's predicted
    config at least ``MIN_AGREEMENT_TPUT`` of the probed one's throughput.
    Returns one message a failed bar."""
    out = []
    overall = doc["lomo"]["overall"]
    if not (overall["median_abs_rel_err"]
            <= overall["analytic_median_abs_rel_err"]):
        out.append(
            f"learned LOMO median abs rel err "
            f"{overall['median_abs_rel_err']:.3f} worse than the analytic "
            f"FIFO model's {overall['analytic_median_abs_rel_err']:.3f}: "
            "the predictor no longer beats the baseline it trains against")
    for name, entry in doc.get("agreement", {}).items():
        if not entry["throughput_ratio"] >= MIN_AGREEMENT_TPUT:
            out.append(
                f"{name}: predicted config holds only "
                f"{entry['throughput_ratio']:.2f}x of the probed config's "
                f"throughput (< {MIN_AGREEMENT_TPUT}): the probe-free mode "
                "is leaving performance on the table")
    return out


def run_entries(entries, fast: bool = FAST):
    """Harvest, LOMO and agreement over ``entries``; returns the printable
    rows and the artifact's payload (``bar_failures`` reads its bars)."""
    batch = 32 if fast else 64
    n_queries = 32 if fast else 64
    rows, trace_records, tuned_configs = [], [], []
    with tempfile.TemporaryDirectory(prefix="costmodel-probe-") as cache, \
            tempfile.TemporaryDirectory(prefix="costmodel-model-") as mcache:
        # -- harvest: traced serves at several wave sizes, audit trails ---
        for name, (cm, mk) in entries.items():
            cfg = autotune_model(cm, batch=batch, mode="probe",
                                 directory=cache, force=True)
            tuned_configs.append(cfg)
            cm.apply_tuned(cfg)
            waves = sorted({cfg.micro_batch, max(1, cfg.micro_batch // 4),
                            32})
            for mb in waves:
                recs, tracer = _traced_records(name, cm, mk, mb, n_queries)
                trace_records.extend(recs)
                export_prediction_records(tracer, os.path.join(
                    bench_dir(), f"COSTMODEL_torch_trace_{name}_mb{mb}.jsonl"))
            rows.append(row(f"costmodel/{name}/harvest", 0.0,
                            waves=",".join(str(w) for w in waves),
                            trace_rows=len([r for r in trace_records
                                            if r["model"] == name]),
                            tuned_mb=cfg.micro_batch,
                            segment_mode=cfg.segment_mode))

        resolver = compiled_feature_resolver(
            {name: cm for name, (cm, _) in entries.items()})
        dataset = build_dataset(resolver, trace_records=trace_records,
                                tuned_configs=tuned_configs)
        table_path = dataset.save(os.path.join(
            bench_dir(), "COSTMODEL_torch_dataset.json"))
        doc = {"fast": fast, "n_rows": len(dataset.rows),
               "models": dataset.models(), "dataset_path": table_path,
               "lomo": {}, "agreement": {}}

        # -- LOMO: the learned model against the analytic one (asserted) --
        doc["lomo"], lomo_rows = lomo_section(dataset.rows)
        rows += lomo_rows

        # -- agreement: probe mode against model mode (asserted) ----------
        predictor = WaveCostPredictor.fit_rows(dataset.rows, **FIT)
        for name, (cm, _) in entries.items():
            probed = load_config(schedule_key(cm), directory=cache)
            predicted = autotune_model(cm, batch=batch, mode="model",
                                       predictor=predictor,
                                       directory=mcache, force=True)
            match = (probed.micro_batch == predicted.micro_batch
                     and probed.segment_mode == predicted.segment_mode)
            entry = {
                "probed": {"micro_batch": probed.micro_batch,
                           "segment_mode": probed.segment_mode},
                "predicted": {"micro_batch": predicted.micro_batch,
                              "segment_mode": predicted.segment_mode},
                "config_match": match,
            }
            if match:
                # one config: timing it twice would measure only noise
                entry["throughput_ratio"] = 1.0
            else:
                x = default_sample(cm, 64)
                t = {}
                for label, cfg in (("probed", probed),
                                   ("predicted", predicted)):
                    cm.apply_tuned(cfg)
                    t[label] = probe_streaming(cm, x, cfg.micro_batch,
                                               iters=3)
                cm.apply_tuned(probed)
                entry["probe_s"] = t
                entry["throughput_ratio"] = t["probed"] / t["predicted"]
            doc["agreement"][name] = entry
            rows.append(row(
                f"costmodel/{name}/agreement", 0.0,
                probed_mb=probed.micro_batch,
                predicted_mb=predicted.micro_batch,
                probed_mode=probed.segment_mode,
                predicted_mode=predicted.segment_mode,
                match=match, tput_ratio=f"{entry['throughput_ratio']:.3f}",
                source=predicted.source))
    print_rows(rows)
    return rows, doc


def run(device=None):
    """Every section, the artifact, then both bars asserted: a failed bar
    raises after its numbers are printed and written."""
    banner("Cost model: LOMO error vs analytic FIFO + autotune agreement")
    rows, doc = run_entries(build_entries(device=device))
    doc["bar_failures"] = bar_failures(doc)
    emit_json("BENCH_torch_costmodel.json", doc)
    require(not doc["bar_failures"], "; ".join(doc["bar_failures"]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
