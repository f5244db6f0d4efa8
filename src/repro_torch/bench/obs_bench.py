"""Observability bench of the port: the NullTracer's overhead and the FIFO
model's prediction error, on the card.

    python -m repro_torch.bench.obs_bench [--device cuda] [--demo]

The port of ``benchmarks/obs_bench.py``. Two numbers gate the obs layer
(``repro_torch.obs``):

  * **Disabled-path overhead.** The executor, the router and the scenarios
    are always instrumented, with the ``NullTracer`` as the default sink.
    That holds only while the disabled path is free: the bench composes the
    ratio of the guarded sites one ``streaming_compiled`` call executes
    (counted by installing a real tracer once), times the disabled path's
    cost per site in a tight loop, divides by the best bare pool time, and
    **asserts** it stays within ``MAX_NULL_OVERHEAD`` (2%). The bare loop
    replays the port's ``streaming_compiled`` without its spans: the same
    padding, FIFO plan and segment programs (``CompiledTinyModel._segment_fn``,
    one ``mlp_megakernel`` launch where the planner admitted a run), so
    both sides run one schedule. The raw wall-clock ratio of the two is
    reported beside it, not asserted (a shared host's noise exceeds 2%).
  * **FIFO-model prediction error.** A traced ``server_streaming`` run
    records every dispatched wave with the cost model's predicted service
    beside its measured span; ``obs.report.prediction_error`` aggregates
    them per (model, platform).

The traced run is also exported as a Chrome trace (``TRACE_torch_serve.json``
in ``REPRO_BENCH_DIR``; open it at https://ui.perfetto.dev). ``--demo``
writes only that timeline. Results land in ``BENCH_torch_obs.json``.
``REPRO_FAST=1`` runs KWS and AD with fewer queries; the full pass adds IC.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.bench.common import (banner, bench_dir, emit_json,
                                      print_rows, require, row)
from repro_torch.bench import table6_scenarios
from repro_torch.deploy.scenarios import offline, server_streaming
from repro_torch.obs import Tracer, export_chrome, timer as obs_timer
from repro_torch.obs.report import latency_percentiles, prediction_error
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve import ServiceModel, measure_wave_service_s

FAST = os.environ.get("REPRO_FAST", "0") not in ("0", "")

#: Disabled-path budget: instrumented-with-NullTracer may cost at most
#: this factor of the bare uninstrumented program on the Offline pool.
MAX_NULL_OVERHEAD = 1.02


def bare_streaming(cm, xb, mb: int):
    """``streaming_compiled`` without its instrumentation: pad, plan, each
    segment's program (or the host interpreter at a host boundary), no
    tracer and no clock."""
    x_p, n, n_m = cm._pad_micro(xb, mb)
    cm.plan_streaming(n_m, micro_batch=mb)
    wave = x_p.reshape((n_m, mb) + tuple(x_p.shape[1:]))
    for k, seg in enumerate(cm.segments):
        if seg.compiled:
            wave = cm._segment_fn(k)(wave)
        else:
            wave = cm._per_micro(cm.schedule.stages[seg.start:seg.stop],
                                 wave)
    return wave.reshape((n_m * mb,) + tuple(wave.shape[2:]))[:n]


def guarded_spans(cm, xb) -> list:
    """(name, args) of every event one ``streaming_compiled`` call records:
    each is one ``if tracer.enabled:`` site the disabled path evaluates."""
    counting = Tracer()
    cm.set_tracer(counting)
    try:
        cm.streaming_compiled(xb)
    finally:
        cm.set_tracer(None)
    return [(e.name, e.args) for e in counting.events()]


def _null_overhead(cm, mk, n_samples: int, iters: int):
    """Disabled-path (NullTracer) overhead on the Offline pool.

    ``overhead_ratio`` is the asserted number, composed from parts that do
    not flap on machine noise: guarded sites per call times the disabled
    path's cost per site, over the best-of-``iters`` bare pool time.
    ``wall_ratio`` is the raw A/B of the instrumented entry point against
    the bare loop, for reading only."""
    xb = np.stack([mk(i) for i in range(n_samples)])
    mb = cm.default_micro_batch

    def timed(fn):
        cm._sync()
        t0 = obs_timer.now()
        fn()
        cm._sync()
        return obs_timer.now() - t0

    timed(lambda: bare_streaming(cm, xb, mb))           # build and warm
    timed(lambda: cm.streaming_compiled(xb))
    bare, instr = [], []
    for _ in range(iters):
        bare.append(timed(lambda: bare_streaming(cm, xb, mb)))
        instr.append(timed(lambda: cm.streaming_compiled(xb)))

    n_sites = len(guarded_spans(cm, xb))

    # disabled-path cost per site (the enabled check and the skipped
    # branch), two guard evaluations a site (span start and record)
    null, reps = NULL_TRACER, 200_000
    t0 = obs_timer.now()
    for _ in range(reps):
        if null.enabled:
            pass                                 # pragma: no cover
        if null.enabled:
            pass                                 # pragma: no cover
    per_site_s = (obs_timer.now() - t0) / reps

    # the Offline scenario over the same program: its per-iteration guards
    # are part of the scenario number itself
    rep = offline(cm.offline, mk, n_samples=n_samples, warmup=1,
                  iters=iters)
    scenario_s = n_samples / rep.throughput_qps

    return {
        "n_samples": n_samples,
        "iters": iters,
        "micro_batch": mb,
        "n_guarded_sites": n_sites,
        "per_site_ns": per_site_s * 1e9,
        "bare_streaming_ms": min(bare) * 1e3,
        "instrumented_null_ms": min(instr) * 1e3,
        "overhead_ratio": 1.0 + (n_sites * per_site_s) / min(bare),
        "wall_ratio": min(instr) / min(bare),
        "offline_scenario_ms": float(scenario_s) * 1e3,
        "budget_ratio": MAX_NULL_OVERHEAD,
    }


def _traced_serve(cm, mk, n_queries: int, tracer: Tracer):
    """One router run on the host clock with tracing on and the service
    model attached, so that every wave span carries ``predicted_ms``."""
    mb = cm.default_micro_batch
    service = ServiceModel.from_compiled(cm, probe_batch=8)
    service = service.recalibrated(measure_wave_service_s(cm, mb), mb)
    return server_streaming(
        cm, mk, qps=0.7 * service.saturation_qps(mb),
        n_queries=n_queries, seed=7,
        max_wait_ms=max(2.0, 1.5 * service.wave_service_s(mb) * 1e3),
        micro_batch=mb, service_model=service, tracer=tracer)


def build_entries(device=None, fast: bool = FAST, seed: int = 0):
    """name -> (compiled model, query maker): KWS and AD, and IC unless
    ``fast``, at full width on ``device``
    (``table6_scenarios.build_entries``)."""
    names = ("KWS-FINN", "AD-hls4ml") + (() if fast else ("IC-hls4ml",))
    return {name: (cm, mk) for name, (cm, mk, _) in
            table6_scenarios.build_entries(names, device=device,
                                           seed=seed).items()}


def _export(tracer: Tracer) -> str:
    return export_chrome(
        tracer, os.path.join(bench_dir(), "TRACE_torch_serve.json"),
        process_names={0: "router", 1: "replica0"})


def run_entries(entries, fast: bool = FAST):
    """The overhead bar (asserted) on the first model, then the traced
    serves, the prediction-error table and the timeline; returns the
    printable rows and the artifact's payload."""
    n_samples = 64 if fast else 256
    iters = 5 if fast else 7
    n_queries = 32 if fast else 96
    rows = []
    doc = {"fast": fast, "null_overhead": {}, "prediction_error": {},
           "span_percentiles": {}}

    # -- disabled-path overhead (asserted) --------------------------------
    name, (cm, mk) = next(iter(entries.items()))
    ov = _null_overhead(cm, mk, n_samples, iters)
    doc["null_overhead"][name] = ov
    rows.append(row(f"obs/{name}/null_overhead",
                    ov["instrumented_null_ms"] * 1e3,
                    bare_ms=f"{ov['bare_streaming_ms']:.3f}",
                    ratio=f"{ov['overhead_ratio']:.6f}",
                    wall_ratio=f"{ov['wall_ratio']:.4f}",
                    sites=ov["n_guarded_sites"],
                    budget=f"{MAX_NULL_OVERHEAD:.2f}"))
    require(ov["overhead_ratio"] <= MAX_NULL_OVERHEAD,
            f"NullTracer overhead_ratio {ov['overhead_ratio']:.4f} exceeds "
            f"{MAX_NULL_OVERHEAD} on the Offline pool: check for "
            f"instrumentation outside `if tracer.enabled:` guards")

    # -- traced serve: prediction error and timeline ----------------------
    tracer = Tracer()
    for name, (cm, mk) in entries.items():
        cm.set_tracer(tracer)
        rep = _traced_serve(cm, mk, n_queries, tracer)
        cm.set_tracer(None)
        pcts = latency_percentiles(tracer, model="m")
        doc["span_percentiles"][name] = pcts
        rows.append(row(f"obs/{name}/traced_serve", rep.p99_ms * 1e3,
                        served=rep.extras["served"],
                        p99_ms=f"{rep.p99_ms:.3f}",
                        span_p99_ms=f"{pcts['p99_ms']:.3f}",
                        waves=rep.extras["n_waves"]))
        for group, stats in prediction_error(tracer).items():
            doc["prediction_error"][f"{name}:{group}"] = stats
            rows.append(row(
                f"obs/{name}/prediction_error",
                stats["predicted_ms_mean"] * 1e3,
                n_waves=stats["n_waves"],
                predicted_ms=f"{stats['predicted_ms_mean']:.3f}",
                measured_ms=f"{stats['measured_ms_mean']:.3f}",
                mean_abs_rel_err=f"{stats['mean_abs_rel_err']:.3f}",
                bias_rel=f"{stats['bias_rel']:+.3f}"))
        tracer.clear()      # one model a timeline

    # the first model again with the tracer kept, for the exported timeline
    name, (cm, mk) = next(iter(entries.items()))
    cm.set_tracer(tracer)
    _traced_serve(cm, mk, n_queries, tracer)
    cm.set_tracer(None)
    path = _export(tracer)
    doc["trace_path"] = path
    doc["trace_events"] = len(tracer)
    rows.append(row("obs/trace_export", 0.0, path=path, events=len(tracer)))
    print_rows(rows)
    return rows, doc


def run(device=None):
    banner("Observability: NullTracer overhead + FIFO prediction error")
    rows, doc = run_entries(build_entries(device=device))
    emit_json("BENCH_torch_obs.json", doc)
    return rows


def demo(device=None):
    """One small traced server run of KWS, exported as a Perfetto-loadable
    timeline (no asserts, no sweep)."""
    banner("Trace demo: one traced server run -> Perfetto timeline")
    cm = table6_scenarios._compile_mlp("KWS-FINN", device=device)
    mk = table6_scenarios.query_maker(cm, np.random.default_rng(0))
    tracer = Tracer()
    cm.set_tracer(tracer)
    rep = _traced_serve(cm, mk, n_queries=32, tracer=tracer)
    cm.set_tracer(None)
    path = _export(tracer)
    print(f"served={rep.extras['served']} waves={rep.extras['n_waves']} "
          f"p99_ms={rep.p99_ms:.3f}")
    print(f"timeline: {path} ({len(tracer)} events); "
          f"open at https://ui.perfetto.dev", flush=True)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--demo", action="store_true",
                    help="only the traced run's timeline export")
    args = ap.parse_args(argv)
    if args.demo:
        demo(args.device)
    else:
        run(args.device)


if __name__ == "__main__":
    main()
