"""Serving benchmark of the port: throughput-at-SLO curves over the
dynamic batcher, on the card.

    python -m repro_torch.bench.serve_bench            # BENCH_torch_serving.json
    python -m repro_torch.bench.serve_bench --scaling  # the replica sweep only

The counterpart of ``benchmarks/serve_bench.py``, whose sections it keeps.
Every Table-1 model at the paper's full width (``bench.models``) is
compiled on the card, autotuned, given an SLO-constrained operating point
(the largest wave whose modeled fill+drain fits the p99 budget), and then
driven through the ``repro_torch.serve`` router with Poisson arrivals at
a sweep of load fractions of its measured saturation throughput. Each
point reports p50/p90/p99 latency, achieved throughput, shed rate and
wave occupancy, and whether every served result equals ``offline``
(``server_streaming`` does the comparison, padded partial waves
included).

The **operating point** per model is the largest swept load whose p99
stayed inside the budget with shed rate < 1%. The **replica-scaling
sweep** is a discrete-event simulation (``serve.sim.ScriptedWaveModel``
under a ``ManualClock``) anchored to each model's measured wave service;
**faults** kills one of two simulated replicas mid-trace, and **cold
start** prices a never-measured model's admission by a predictor fitted
to the other models' anchors. Everything lands in
``BENCH_torch_serving.json`` (``REPRO_BENCH_DIR``).

Set REPRO_FAST=1 for a reduced-size pass.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from repro_torch.bench.common import banner, emit_json, print_rows, row
from repro_torch.bench.table6_scenarios import build_entries
from repro_torch.deploy.autotune import autotune_model
from repro_torch.deploy.scenarios import server_streaming
from repro_torch.serve import (
    AsyncEngine,
    ManualClock,
    PredictedServiceModel,
    Router,
    RouterConfig,
    ServiceModel,
    SyncEngine,
    measure_wave_service_s,
    poisson_trace,
    slo_operating_point,
)
from repro_torch.serve.sim import scripted_pool

FAST = os.environ.get("REPRO_FAST", "0") not in ("0", "")

#: Swept offered-load fractions of the modeled saturation throughput.
LOAD_FRACTIONS = (0.7, 1.1) if FAST else (0.3, 0.5, 0.7, 0.9, 1.1)

#: Shed-rate ceiling for a load point to count as "inside SLO".
SHED_CEILING = 0.01

#: Replica counts for the scaling sweep.
SCALING_REPLICAS = (1, 2, 4)

#: Scaling-sweep load fractions of the *aggregate* (replicas x per-replica
#: saturation) throughput — lower than LOAD_FRACTIONS because the sync
#: contrast rows need sub-ceiling points to land a valid operating point.
#: Not reduced under FAST: the sweep is a pure event loop, and a coarse
#: fraction grid makes the operating point (and the 1->2 scaling ratio)
#: a lottery on whichever single point survives the SLO filter.
SCALING_FRACTIONS = (0.25, 0.4, 0.6, 0.7, 0.8, 0.95)

#: Queries per scaling simulation point (pure event loop — cheap).
#: ``bench_scaling`` raises this to 40 waves' worth when the tuned wave
#: is large, so the p99 of a point never rests on a handful of waves.
SCALING_QUERIES = 160 if FAST else 400


def _budget_ms(service: ServiceModel, micro_batch: int) -> float:
    """Per-model p99 budget: 6x the modeled tuned-wave service time,
    floored at 10 ms. Derived (not hard-coded) so the same bench stays
    meaningful across machines an order of magnitude apart."""
    return max(10.0, 6.0 * service.wave_service_s(micro_batch) * 1e3)


def bench_model(name: str, cm, mk, n_queries: int,
                fractions=LOAD_FRACTIONS):
    """The load curve of one model: its operating point under a p99
    budget, the saturation measured through the router, and one
    ``server_streaming`` run per load fraction. A model without a tuned
    config is autotuned first (``autotune_model``'s cache)."""
    if cm.tuned is None:
        cm.apply_tuned(autotune_model(cm, batch=32 if FAST else 64))
    # model-first service estimate, pinned to reality by ONE measured wave
    # probe at the tuned wave size — stage compute alone misses the
    # per-wave dispatch overhead that dominates small models, and a
    # capacity plan from the raw model would sweep pure overload
    service = ServiceModel.from_compiled(cm, probe_batch=8)
    tuned_mb = cm.default_micro_batch
    service = service.recalibrated(
        measure_wave_service_s(cm, tuned_mb), tuned_mb)
    budget = _budget_ms(service, tuned_mb)
    # the wave's own service may take at most ~25% of the budget: the
    # admission estimate adds the batching wait (1.5x service below) and
    # queued waves on top, and est(empty queue) must clear the budget or
    # the controller sheds everything before the first wave forms.
    # Fixed-point-iterate the choice: dispatch overhead is flat across
    # wave sizes, so a model calibrated at the tuned wave is optimistic
    # about smaller waves — re-measure at the chosen wave until it
    # settles, and the modeled saturation the sweep scales is honest.
    point = slo_operating_point(service, 0.25 * budget)
    mb = int(point["micro_batch"])
    for _ in range(2):
        service = service.recalibrated(measure_wave_service_s(cm, mb), mb)
        point = slo_operating_point(service, 0.25 * budget)
        if int(point["micro_batch"]) == mb:
            break
        mb = int(point["micro_batch"])
    # deadline long enough that full waves can form at sub-saturation load
    max_wait_ms = max(2.0, 1.5 * service.wave_service_s(mb) * 1e3)

    # honest saturation: drive the router itself far past the modeled
    # peak with shedding off — back-to-back full waves through the real
    # dispatch loop (router bookkeeping included) — and read the achieved
    # throughput back as the capacity the sweep scales. The service model
    # is pinned to that number too, so the admission controller and the
    # offered load agree about what a wave really costs end to end.
    probe = server_streaming(
        cm, mk, qps=3.0 * service.saturation_qps(mb),
        n_queries=n_queries, seed=17, max_wait_ms=max_wait_ms,
        micro_batch=mb, warmup=1)
    sat_qps = probe.throughput_qps
    service = service.recalibrated(mb / sat_qps, mb)
    budget = max(budget, 3.5 * service.wave_service_s(mb) * 1e3)
    max_wait_ms = max(2.0, 1.5 * service.wave_service_s(mb) * 1e3)

    curve = []
    for frac in fractions:
        rep = server_streaming(
            cm, mk, qps=frac * sat_qps, n_queries=n_queries,
            seed=int(frac * 100), max_wait_ms=max_wait_ms,
            p99_budget_ms=budget, micro_batch=mb, service_model=service)
        curve.append({
            "load_fraction": frac,
            "offered_qps": rep.extras["offered_qps"],
            "achieved_qps": rep.throughput_qps,
            "p50_ms": rep.p50_ms, "p90_ms": rep.p90_ms, "p99_ms": rep.p99_ms,
            "shed_rate": rep.extras["shed_rate"],
            "served": rep.extras["served"], "shed": rep.extras["shed"],
            "wave_occupancy": rep.extras["wave_occupancy"],
            "met_slo": rep.extras["met_slo"],
            "bit_exact_vs_offline": rep.extras.get("bit_exact_vs_offline"),
        })

    inside = [c for c in curve
              if c["met_slo"] and c["shed_rate"] < SHED_CEILING]
    op = max(inside, key=lambda c: c["achieved_qps"]) if inside else None
    return {
        "micro_batch": mb,
        "p99_budget_ms": budget,
        "max_wait_ms": max_wait_ms,
        "measured_saturation_qps": sat_qps,
        "wave_service_ms": service.wave_service_s(mb) * 1e3,
        "service_calibration": service.calibration,
        "slo_candidates": point["candidates"],
        "curve": curve,
        "operating_point": op,
    }


# ---------------------------------------------------------------------------
# replica-scaling sweep (discrete-event simulation, measured service anchor)
# ---------------------------------------------------------------------------

def _scaling_service_model(service_s: float, mb: int) -> ServiceModel:
    """One-stage ServiceModel calibrated so ``wave_service_s(mb)`` equals
    ``service_s`` exactly — the scripted lane gets the same admission and
    placement arithmetic a probe-calibrated real model would."""
    model = ServiceModel(works=[("s", 0)], sec_per_cycle=1.0)
    model.sec_per_cycle = service_s / max(model.wave_cycles(mb), 1)
    return model


def _scaling_point(service_s: float, mb: int, n_replicas: int, engine_cls,
                   frac: float, budget_ms: float, max_wait_ms: float,
                   n_queries: int, seed: int):
    """One simulated load point: ``n_replicas`` scripted replicas (each a
    hand-checkable ``service_s``-per-wave device), Poisson arrivals at
    ``frac`` of the pool's aggregate saturation, full router in the loop
    (admission, deadline batching, placement, reaping)."""
    clock = ManualClock()
    pool = scripted_pool(clock, [service_s] * n_replicas, micro_batch=mb)
    router = Router(
        {"m": pool},
        RouterConfig(max_wait_ms=max_wait_ms, micro_batch=mb,
                     p99_budget_ms=budget_ms),
        clock=clock,
        service_models={"m": _scaling_service_model(service_s, mb)},
        engine=engine_cls())
    offered = frac * n_replicas * (mb / service_s)
    trace = poisson_trace(qps=offered, n=n_queries, seed=seed)
    reqs = router.run_trace(
        "m", trace, lambda i: np.full((2,), i % 128, np.int32))
    served = [r for r in reqs if not r.shed]
    lats_ms = np.asarray([r.latency_s for r in served]) * 1e3
    span = (max(r.done_t for r in served)
            - min(r.arrival_t for r in served)) if served else 0.0
    p99 = float(np.percentile(lats_ms, 99)) if served else float("inf")
    return {
        "load_fraction": frac,
        "offered_qps": offered,
        "achieved_qps": len(served) / max(span, 1e-12),
        "p99_ms": p99,
        "shed_rate": 1.0 - len(served) / len(reqs),
        "met_slo": bool(served) and p99 <= budget_ms,
    }


def bench_scaling(name: str, service_s: float, mb: int,
                  n_queries: int = SCALING_QUERIES):
    """Throughput-at-p99-SLO vs replica count for one model family, async
    vs sync engine. ``service_s`` is the family's measured wave service
    time on the real compiled model — the simulation's only free
    parameter, so the sweep isolates engine scheduling from device count.
    """
    budget_ms = max(10.0, 6.0 * service_s * 1e3)
    max_wait_ms = max(2.0, 1.5 * service_s * 1e3)
    n_queries = max(n_queries, 40 * mb)
    out = {"wave_service_ms": service_s * 1e3, "micro_batch": mb,
           "p99_budget_ms": budget_ms, "max_wait_ms": max_wait_ms,
           "replica_counts": list(SCALING_REPLICAS),
           "load_fractions": list(SCALING_FRACTIONS),
           "n_queries": n_queries, "engines": {}}
    for engine_name, engine_cls in (("async", AsyncEngine),
                                    ("sync", SyncEngine)):
        per_n = {}
        for n in SCALING_REPLICAS:
            curve = [
                _scaling_point(
                    service_s, mb, n, engine_cls, frac, budget_ms,
                    max_wait_ms, n_queries,
                    seed=10_000 * n + int(frac * 1000)
                    + (5_000 if engine_cls is SyncEngine else 0))
                for frac in SCALING_FRACTIONS]
            inside = [c for c in curve
                      if c["met_slo"] and c["shed_rate"] < SHED_CEILING]
            per_n[str(n)] = {
                "curve": curve,
                "qps_at_slo": (max(c["achieved_qps"] for c in inside)
                               if inside else None),
            }
        out["engines"][engine_name] = per_n
    a = out["engines"]["async"]
    base = a["1"]["qps_at_slo"]
    if base:
        for n in SCALING_REPLICAS[1:]:
            qn = a[str(n)]["qps_at_slo"] or 0.0
            out[f"scaling_1_to_{n}"] = qn / base
    return out


# ---------------------------------------------------------------------------
# degraded capacity: 1-of-2 replicas killed mid-trace (fault handling bench)
# ---------------------------------------------------------------------------

def bench_faults(service_s: float, mb: int, n_queries: int = 200,
                 seed: int = 23):
    """Kill one of two replicas halfway through a Poisson trace at 0.7x
    the *aggregate* saturation and report the degradation: pre- vs
    post-kill p99, shed rate, and the zero-lost guarantee (every admitted
    request is either served or shed with a typed reason — never hung,
    never silently dropped). Discrete-event simulation anchored to the
    measured wave service like the scaling sweep, so the row is exact and
    reproducible."""
    from repro_torch.serve import FaultPlan, FaultSpec
    from repro_torch.serve.replica import QUARANTINED

    budget_ms = max(10.0, 6.0 * service_s * 1e3)
    max_wait_ms = max(2.0, 1.5 * service_s * 1e3)
    offered = 0.7 * 2 * (mb / service_s)
    trace = poisson_trace(qps=offered, n=n_queries, seed=seed)
    t_kill = float(np.asarray(trace.arrivals)[n_queries // 2])
    clock = ManualClock()
    plan = FaultPlan([FaultSpec("replica_crash", replica=0,
                                after_t=t_kill,
                                duration_s=float("inf"))])
    pool = scripted_pool(clock, [service_s] * 2, micro_batch=mb,
                         plan=plan)
    router = Router(
        {"m": pool},
        RouterConfig(max_wait_ms=max_wait_ms, micro_batch=mb,
                     p99_budget_ms=budget_ms, wave_timeout_mult=3.0,
                     retry_backoff_ms=0.5, max_retries=2),
        clock=clock,
        service_models={"m": _scaling_service_model(service_s, mb)},
        engine=AsyncEngine())
    reqs = router.run_trace(
        "m", trace, lambda i: np.full((2,), i % 128, np.int32))

    lost = [r for r in reqs if not r.shed and r.result is None]
    if lost:
        # the headline guarantee of the fault handling; a bench that
        # quietly published rows past this would be lying about it
        raise RuntimeError(
            f"fault bench lost {len(lost)} admitted requests "
            f"(uids {[r.uid for r in lost[:8]]}) — the zero-lost "
            "guarantee is broken")

    def _stats(rs):
        served = [r for r in rs if not r.shed]
        lats = np.asarray([r.latency_s for r in served]) * 1e3
        return {
            "n": len(rs), "served": len(served),
            "shed_rate": 1.0 - len(served) / len(rs) if rs else 0.0,
            "p99_ms": float(np.percentile(lats, 99)) if served else None,
        }

    snap = router.stats()["m"]["metrics"]
    return {
        "offered_qps": offered, "micro_batch": mb,
        "wave_service_ms": service_s * 1e3,
        "p99_budget_ms": budget_ms, "t_kill_s": t_kill,
        "pre_kill": _stats([r for r in reqs if r.arrival_t < t_kill]),
        "post_kill": _stats([r for r in reqs if r.arrival_t >= t_kill]),
        "fault_counts": dict(snap.fault_counts),
        "shed_reasons": dict(snap.shed_reasons),
        "killed_replica_quarantined":
            pool.replicas[0].health == QUARANTINED,
        "zero_lost": True,
    }


# ---------------------------------------------------------------------------
# cold start: predictor-priced admission from wave 0 vs the unpriced path
# ---------------------------------------------------------------------------

def _fleet_predicted_service_s(entries, measured, cold_name: str) -> float:
    """Predict the cold family's wave service from the REST of the fleet.

    The fleet story end to end: train a ``repro_torch.costmodel``
    predictor on the other families' measured wave anchors (features from
    their static compiled structure), then price the cold family's wave having never
    measured it — leave-one-out at the fleet level, exactly what a server
    must do for a model it has never seen."""
    from repro_torch.costmodel import WaveCostPredictor, wave_features

    rows = []
    for name, (cm, mk) in entries.items():
        if name == cold_name:
            continue
        m = measured[name]
        rows.append({"model": name,
                     "features": wave_features(cm, m["micro_batch"]),
                     "measured_ms": m["wave_service_ms"]})
    pred = WaveCostPredictor.fit_rows(rows, l2=1.0, seed=0, n_members=4)
    cold_cm = entries[cold_name][0]
    mb = measured[cold_name]["micro_batch"]
    return float(pred.predict_ms(wave_features(cold_cm, mb))) / 1e3


def bench_cold_start(service_s: float, predicted_s: float, mb: int,
                     n_queries: int = 480, seed: int = 31):
    """A cold model at overload, with vs without predictor-priced admission.

    Both runs are exact discrete-event simulations (``ManualClock`` +
    scripted replica) of the same overloaded Poisson trace (2.5x
    saturation) against a model the server has NEVER measured. The p99
    budget is priced off the *prediction* (3x predicted service) — the
    only service number a cold model has; pricing it off the true
    service would assume the very measurement cold start lacks, and an
    overestimating predictor would then shed everything and starve the
    EWMA of the samples it needs to correct. The "predicted" run prices
    admission from wave 0 with a ``PredictedServiceModel`` anchored on
    the fleet predictor's estimate (the SLO controller's EWMA then
    corrects toward the true service online); the "unpriced" run is the
    status quo for an unmeasured model — no admission control, so
    overload queues instead of shedding and the p99 blows through the
    budget. The headline numbers are the p99 and shed-rate deltas
    between the two."""
    budget_ms = max(5.0, 3.0 * predicted_s * 1e3)
    max_wait_ms = max(2.0, 1.5 * predicted_s * 1e3)
    offered = 2.5 * (mb / service_s)
    trace = poisson_trace(qps=offered, n=n_queries, seed=seed)
    out = {"offered_qps": offered, "load_fraction": 2.5,
           "micro_batch": mb, "wave_service_ms": service_s * 1e3,
           "predicted_wave_ms": predicted_s * 1e3,
           "prediction_rel_err": abs(predicted_s - service_s) / service_s,
           "p99_budget_ms": budget_ms, "n_queries": n_queries}
    for label, priced in (("predicted", True), ("unpriced", False)):
        clock = ManualClock()
        pool = scripted_pool(clock, [service_s], micro_batch=mb)
        router = Router(
            {"m": pool},
            RouterConfig(max_wait_ms=max_wait_ms, micro_batch=mb,
                         p99_budget_ms=budget_ms if priced else None),
            clock=clock,
            service_models={"m": PredictedServiceModel.from_table(
                [("s", 0)], {mb: predicted_s})} if priced else None,
            engine=AsyncEngine())
        reqs = router.run_trace(
            "m", trace, lambda i: np.full((2,), i % 128, np.int32))
        served = [r for r in reqs if not r.shed]
        lats_ms = np.asarray([r.latency_s for r in served]) * 1e3
        p99 = float(np.percentile(lats_ms, 99)) if served else None
        out[label] = {
            "served": len(served),
            "shed_rate": 1.0 - len(served) / len(reqs),
            "p99_ms": p99,
            "met_slo": p99 is not None and p99 <= budget_ms,
        }
    if (out["predicted"]["p99_ms"] is not None
            and out["unpriced"]["p99_ms"] is not None):
        out["p99_delta_ms"] = (out["unpriced"]["p99_ms"]
                               - out["predicted"]["p99_ms"])
    out["shed_rate_delta"] = (out["predicted"]["shed_rate"]
                              - out["unpriced"]["shed_rate"])
    return out


def _build_entries():
    """The four Table-1 models at the paper's full width on the card, each
    with its query maker (``table6_scenarios.build_entries``)."""
    return {name: (cm, mk)
            for name, (cm, mk, _) in build_entries().items()}


def _scaling_rows(name: str, sc) -> list:
    """Printable summary rows for one family's scaling sweep."""
    a = sc["engines"]["async"]
    s = sc["engines"]["sync"]

    def q(tab, n):
        v = tab[str(n)]["qps_at_slo"]
        return "-" if v is None else f"{v:.0f}"

    return [row(
        f"serve/{name}/scaling", 0.0,
        wave_ms=f"{sc['wave_service_ms']:.3f}",
        micro_batch=sc["micro_batch"],
        async_qps_1=q(a, 1), async_qps_2=q(a, 2), async_qps_4=q(a, 4),
        sync_qps_2=q(s, 2),
        x_1_to_2=(f"{sc['scaling_1_to_2']:.2f}"
                  if "scaling_1_to_2" in sc else "-"),
        x_1_to_4=(f"{sc['scaling_1_to_4']:.2f}"
                  if "scaling_1_to_4" in sc else "-"))]


def run_scaling_only():
    """Standalone replica-scaling sweep: autotune each family, measure its
    real wave service time, and run the discrete-event sweep from that
    anchor — skipping the full load-curve bench."""
    banner("Serving: replica scaling (simulated pool, measured service)")
    entries = _build_entries()
    rows = []
    doc = {"fast": FAST, "models": {}}
    for name, (cm, mk) in entries.items():
        cfg = autotune_model(cm, batch=32 if FAST else 64)
        cm.apply_tuned(cfg)
        mb = cm.default_micro_batch
        sc = bench_scaling(name, measure_wave_service_s(cm, mb), mb)
        doc["models"][name] = sc
        rows.extend(_scaling_rows(name, sc))
    print_rows(rows)
    emit_json("BENCH_torch_serving_scaling.json", doc)
    return rows


def run():
    banner("Serving: throughput-at-SLO over the dynamic-batching router")
    n_queries = 48 if FAST else 128
    entries = _build_entries()

    rows = []
    doc = {"models": {}, "scaling": {}, "fast": FAST,
           "load_fractions": list(LOAD_FRACTIONS),
           "shed_ceiling": SHED_CEILING}
    for name, (cm, mk) in entries.items():
        res = bench_model(name, cm, mk, n_queries)
        doc["models"][name] = res
        # replica-scaling sweep anchored to this family's measured wave
        # service (pinned to the saturation probe above)
        sc = bench_scaling(name, res["wave_service_ms"] / 1e3,
                           res["micro_batch"])
        doc["scaling"][name] = sc
        rows.extend(_scaling_rows(name, sc))
        for c in res["curve"]:
            rows.append(row(
                f"serve/{name}/load{c['load_fraction']:.1f}",
                c["p99_ms"] * 1e3,
                offered_qps=f"{c['offered_qps']:.0f}",
                achieved_qps=f"{c['achieved_qps']:.0f}",
                p99_ms=f"{c['p99_ms']:.3f}",
                budget_ms=f"{res['p99_budget_ms']:.1f}",
                shed_rate=f"{c['shed_rate']:.3f}",
                occupancy=f"{c['wave_occupancy']:.2f}",
                met_slo=c["met_slo"],
                bit_exact=c["bit_exact_vs_offline"]))
        op = res["operating_point"]
        rows.append(row(
            f"serve/{name}/operating_point", 0.0,
            micro_batch=res["micro_batch"],
            budget_ms=f"{res['p99_budget_ms']:.1f}",
            saturation_qps=f"{res['measured_saturation_qps']:.0f}",
            qps_at_slo=("-" if op is None
                        else f"{op['achieved_qps']:.0f}"),
            at_load=("-" if op is None else op["load_fraction"])))
    # degraded-capacity row: 1-of-2 replicas killed at t=half, anchored to
    # the first family's measured wave service (the fault machinery is
    # model-agnostic; one exact simulated row tracks it across PRs)
    anchor = next(iter(doc["models"]))
    flt = bench_faults(doc["models"][anchor]["wave_service_ms"] / 1e3,
                       doc["models"][anchor]["micro_batch"])
    doc["faults"] = {"anchor_model": anchor, **flt}
    rows.append(row(
        "serve/faults/kill_1of2", 0.0,
        offered_qps=f"{flt['offered_qps']:.0f}",
        pre_p99_ms=(f"{flt['pre_kill']['p99_ms']:.3f}"
                    if flt["pre_kill"]["p99_ms"] is not None else "-"),
        post_p99_ms=(f"{flt['post_kill']['p99_ms']:.3f}"
                     if flt["post_kill"]["p99_ms"] is not None else "-"),
        post_shed=f"{flt['post_kill']['shed_rate']:.3f}",
        quarantined=flt["killed_replica_quarantined"],
        zero_lost=flt["zero_lost"]))
    # cold-start row: the anchor family served as if NEVER measured —
    # admission priced by the fleet predictor (trained on the other
    # families' anchors) from wave 0, vs today's unpriced cold start
    pred_s = _fleet_predicted_service_s(entries, doc["models"], anchor)
    cold = bench_cold_start(doc["models"][anchor]["wave_service_ms"] / 1e3,
                            pred_s, doc["models"][anchor]["micro_batch"])
    doc["cold_start"] = {"anchor_model": anchor, **cold}
    rows.append(row(
        "serve/cold_start/predicted_vs_unpriced", 0.0,
        predicted_ms=f"{cold['predicted_wave_ms']:.3f}",
        true_ms=f"{cold['wave_service_ms']:.3f}",
        pred_err=f"{cold['prediction_rel_err']:.2f}",
        priced_p99_ms=(f"{cold['predicted']['p99_ms']:.3f}"
                       if cold["predicted"]["p99_ms"] is not None else "-"),
        unpriced_p99_ms=(f"{cold['unpriced']['p99_ms']:.3f}"
                         if cold["unpriced"]["p99_ms"] is not None else "-"),
        shed_delta=f"{cold['shed_rate_delta']:+.3f}",
        priced_met_slo=cold["predicted"]["met_slo"]))
    print_rows(rows)
    emit_json("BENCH_torch_serving.json", doc)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scaling", action="store_true",
                    help="run only the replica-scaling sweep "
                         "(emits BENCH_torch_serving_scaling.json)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_bench: no CUDA device; the bench serves on the card",
              file=sys.stderr)
        return 2
    if args.scaling:
        run_scaling_only()
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
