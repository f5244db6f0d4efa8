"""MLPerf-Tiny-style load scenarios over a compiled executor, on torch.

The port of ``repro.deploy.scenarios``: the LoadGen modes against any
object with an ``offline(x) -> y`` callable (``deploy.executor`` compiled
models):

  * SingleStream — one query at a time, batch 1; latency percentiles
    (MLPerf scores the 90th; reported p50/p90/p99). The paper's latency and
    energy per inference are its SingleStream results.
  * MultiStream  — N concurrent streams issued as one batch per step.
  * Offline      — the whole query pool in one batch; max throughput.
  * Server       — Poisson arrivals at a target QPS into a single queue;
    latency includes queueing delay.
  * StreamingOffline — the Offline pool through ``streaming_compiled`` at
    the executor's (tuned) micro-batch.

  * ServerStreaming — Poisson arrivals through the dynamic-batching
    router (``repro_torch.serve``): padded micro-batch waves through
    ``submit_wave``, SLO shedding, every served result checked against
    ``offline``.

A query's time ends when its output is ready: where the reference blocks
on the JAX array, the port synchronises the CUDA device the output lies on
(``_ready``); CPU tensors and numpy arrays are ready when returned. The
router waits for each wave through its CUDA event. Each report carries the
roofline energy proxy of ``core.codesign.deploy_report`` (the card's
constants) beside a measured proxy, the card's power limit times the
median latency.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.codesign import CHIP_WATTS, deploy_report
from repro_torch.obs import timer as obs_timer
from repro_torch.obs.tracer import NULL_TRACER


@dataclasses.dataclass
class ScenarioReport:
    scenario: str
    n_queries: int
    p50_ms: float
    p90_ms: float
    p99_ms: float
    throughput_qps: float
    energy_proxy_uJ: Optional[float] = None      # roofline (BOPs) model
    measured_energy_uJ: Optional[float] = None   # card watts x latency
    stage_ms: Optional[List[Dict]] = None        # per-stage latency breakdown
    extras: Dict = dataclasses.field(default_factory=dict)

    def row(self) -> Dict[str, object]:
        d = {
            "scenario": self.scenario,
            "n": self.n_queries,
            "p50_ms": round(self.p50_ms, 4),
            "p90_ms": round(self.p90_ms, 4),
            "p99_ms": round(self.p99_ms, 4),
            "qps": round(self.throughput_qps, 1),
        }
        if self.energy_proxy_uJ is not None:
            d["roofline_uJ"] = round(self.energy_proxy_uJ, 3)
        if self.measured_energy_uJ is not None:
            d["measured_uJ"] = round(self.measured_energy_uJ, 1)
        if self.stage_ms is not None:
            d["stage_ms"] = "|".join(
                f"{s['stage']}:{s['ms']:.3f}" for s in self.stage_ms)
        d.update(self.extras)
        return d


def _ready(y):
    """Wait until ``y`` (a tensor, or a tuple whose first item is one) is
    computed: synchronise the CUDA device it lies on. Returns ``y``."""
    t = y[0] if isinstance(y, tuple) else y
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return y


def _host(y) -> np.ndarray:
    """An output on the host as numpy (one copy for a tensor)."""
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


def _percentiles(lat_s: List[float]) -> Dict[str, float]:
    a = np.asarray(lat_s) * 1e3
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99))}


def _finish(scenario, lats, n, span, model_cost=None, bits=8,
            stage_ms=None, **extras):
    p = _percentiles(lats)
    energy = None
    if model_cost is not None:
        energy = deploy_report(model_cost, batch=1, bits=bits)["energy_uJ"]
    return ScenarioReport(
        scenario=scenario, n_queries=n,
        p50_ms=p["p50"], p90_ms=p["p90"], p99_ms=p["p99"],
        throughput_qps=n / max(span, 1e-9),
        energy_proxy_uJ=energy,
        measured_energy_uJ=float(np.median(lats)) * CHIP_WATTS * 1e6,
        stage_ms=stage_ms,
        extras=extras)


def _stage_breakdown(compiled, x) -> Optional[List[Dict]]:
    """Per-stage latency probe on a representative batch, when the executor
    exposes one (``CompiledTinyModel.stage_latencies``); None otherwise."""
    probe = getattr(compiled, "stage_latencies", None)
    if probe is None:
        return None
    return probe(x)


def single_stream(infer: Callable, make_query: Callable[[int], np.ndarray],
                  n_queries: int = 64, warmup: int = 3,
                  model_cost=None, bits: int = 8,
                  compiled=None, tracer=None) -> ScenarioReport:
    """Batch-1 queries back to back; MLPerf scores p90 latency.

    ``make_query(i)`` returns ONE unbatched sample; the scenario adds the
    batch-1 axis. Pass the compiled executor as ``compiled`` to attach a
    per-stage latency breakdown."""
    tr = tracer if tracer is not None else NULL_TRACER
    for w in range(warmup):
        _ready(infer(np.asarray(make_query(w))[None]))
    lats = []
    t_start = obs_timer.now()
    for i in range(n_queries):
        x = np.asarray(make_query(i))[None]
        t0 = obs_timer.now()
        _ready(infer(x))
        lats.append(obs_timer.now() - t0)
    span = obs_timer.now() - t_start
    if tr.enabled:
        tr.add_span("scenario", t_start, t_start + span, cat="scenario",
                    args={"scenario": "SingleStream", "n": n_queries})
    stage_ms = (None if compiled is None
                else _stage_breakdown(compiled,
                                      np.asarray(make_query(0))[None]))
    return _finish("SingleStream", lats, n_queries, span, model_cost, bits,
                   stage_ms=stage_ms)


def multi_stream(infer: Callable, make_query: Callable[[int], np.ndarray],
                 n_streams: int = 8, n_queries: int = 64, warmup: int = 2,
                 model_cost=None, bits: int = 8,
                 tracer=None) -> ScenarioReport:
    """N concurrent streams per step: one batched inference serves all
    streams; a step's latency applies to every query in it."""
    tr = tracer if tracer is not None else NULL_TRACER
    steps = max(1, n_queries // n_streams)
    batch0 = np.stack([make_query(s) for s in range(n_streams)])
    for _ in range(warmup):
        _ready(infer(batch0))
    lats = []
    t_start = obs_timer.now()
    for i in range(steps):
        xb = np.stack([make_query(i * n_streams + s)
                       for s in range(n_streams)])
        t0 = obs_timer.now()
        _ready(infer(xb))
        lats.extend([obs_timer.now() - t0] * n_streams)
    span = obs_timer.now() - t_start
    if tr.enabled:
        tr.add_span("scenario", t_start, t_start + span, cat="scenario",
                    args={"scenario": "MultiStream",
                          "n": steps * n_streams, "streams": n_streams})
    return _finish("MultiStream", lats, steps * n_streams, span,
                   model_cost, bits, streams=n_streams)


def offline(infer: Callable, make_query: Callable[[int], np.ndarray],
            n_samples: int = 256, warmup: int = 2, iters: int = 3,
            model_cost=None, bits: int = 8, compiled=None,
            tracer=None) -> ScenarioReport:
    """Whole pool in one batch; the throughput scenario. Reports the
    median span of ``iters`` runs after the warm-up."""
    tr = tracer if tracer is not None else NULL_TRACER
    xb = np.stack([make_query(i) for i in range(n_samples)])
    for _ in range(warmup):
        _ready(infer(xb))
    spans = []
    for it in range(max(iters, 1)):
        t0 = obs_timer.now()
        _ready(infer(xb))
        t1 = obs_timer.now()
        if tr.enabled:
            tr.add_span("scenario", t0, t1, cat="scenario",
                        args={"scenario": "Offline", "n": n_samples,
                              "iter": it})
        spans.append(t1 - t0)
    spans.sort()
    span = spans[len(spans) // 2]
    per_query = span / n_samples
    stage_ms = None if compiled is None else _stage_breakdown(compiled, xb)
    return _finish("Offline", [per_query] * n_samples, n_samples, span,
                   model_cost, bits, stage_ms=stage_ms, batch=n_samples,
                   iters=max(iters, 1))


def streaming_pipeline(compiled, make_query: Callable[[int], np.ndarray],
                       n_samples: int = 256, micro_batch: Optional[int] = None,
                       warmup: int = 1, iters: int = 3,
                       model_cost=None, bits: int = 8,
                       tracer=None) -> ScenarioReport:
    """The Offline pool through ``compiled.streaming_compiled``;
    ``micro_batch=None`` takes the executor's tuned default. Reports the
    median span of ``iters`` runs, and the FIFO plan that scheduled it."""
    tr = tracer if tracer is not None else NULL_TRACER
    xb = np.stack([make_query(i) for i in range(n_samples)])
    for _ in range(max(warmup, 1)):
        _ready(compiled.streaming_compiled(xb, micro_batch=micro_batch))
    spans = []
    stats = None
    for it in range(max(iters, 1)):
        t0 = obs_timer.now()
        _, stats = _ready(compiled.streaming_compiled(
            xb, micro_batch=micro_batch))
        t1 = obs_timer.now()
        if tr.enabled:
            tr.add_span("scenario", t0, t1, cat="scenario",
                        args={"scenario": "StreamingOffline",
                              "n": n_samples, "iter": it})
        spans.append(t1 - t0)
    spans.sort()
    span = spans[len(spans) // 2]
    return _finish("StreamingOffline", [span / n_samples] * n_samples,
                   n_samples, span, model_cost, bits,
                   micro_batch=stats.micro_batch,
                   fifo_depths=str(stats.fifo_depths),
                   segments=str(stats.segments), batch=n_samples)


def server_poisson(infer: Callable, make_query: Callable[[int], np.ndarray],
                   qps: float = 200.0, n_queries: int = 128, seed: int = 0,
                   warmup: int = 3, model_cost=None, bits: int = 8,
                   tracer=None) -> ScenarioReport:
    """Poisson arrivals into a single-worker FIFO queue: latency = queueing
    delay + service. Arrivals are drawn up front and the whole query pool
    is built before the clock starts; the warm-up ends with a discarded
    warm call on a pool query."""
    tr = tracer if tracer is not None else NULL_TRACER
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, n_queries))
    queries = [np.asarray(make_query(i))[None] for i in range(n_queries)]
    for w in range(max(warmup, 1)):
        _ready(infer(queries[w % n_queries]))
    _ready(infer(queries[0]))               # discarded warm iteration
    lats = []
    t_start = obs_timer.now()
    free_at = 0.0
    for i in range(n_queries):
        now = obs_timer.now() - t_start
        if now < arrivals[i]:
            obs_timer.sleep(arrivals[i] - now)
        _ready(infer(queries[i]))
        done = obs_timer.now() - t_start
        lats.append(done - arrivals[i])
        free_at = done
    span = free_at - arrivals[0]
    if tr.enabled:
        tr.add_span("scenario", t_start, t_start + free_at, cat="scenario",
                    args={"scenario": "Server", "n": n_queries,
                          "offered_qps": qps})
    return _finish("Server", lats, n_queries, span, model_cost, bits,
                   offered_qps=qps)


def server_streaming(compiled, make_query: Callable[[int], np.ndarray],
                     qps: float = 200.0, n_queries: int = 128, seed: int = 0,
                     max_wait_ms: float = 2.0,
                     p99_budget_ms: Optional[float] = None,
                     micro_batch: Optional[int] = None,
                     service_model=None, warmup: int = 1,
                     model_cost=None, bits: int = 8,
                     tracer=None, engine=None) -> ScenarioReport:
    """MLPerf Server mode over the dynamic-batching serve router.

    Where ``server_poisson`` serves each arrival alone (batch 1, one
    worker), this scenario drives the ``repro_torch.serve`` router: Poisson
    arrivals are coalesced into padded micro-batch waves (the autotuned
    wave size by default, ``max_wait_ms`` deadline) and dispatched through
    the executor's segment programs — the streaming pipeline fed by
    request traffic rather than a pre-batched pool. With a
    ``p99_budget_ms`` the SLO controller sheds load it estimates would
    blow the budget; shed requests count into ``shed_rate`` but not into
    the latency percentiles (MLPerf Server accounting: an over-SLO result
    is invalid either way, an explicit shed is at least cheap).

    On the card the warm-up also runs one wave on the router's replica
    stream (``ReplicaPool.warm``): a fresh stream's first wave pays the
    caching allocator's and cuBLAS's one-time setup.

    When the executor exposes ``offline``, every served result is checked
    bit-exact against it (``extras["bit_exact_vs_offline"]``) — padded
    partial waves included, which is the wave-padding contract under real
    traffic. Float outputs are held within 1e-6, the reference's
    tolerance; on the card the float head's logits may depend on the
    wave's row count (cuBLAS picks its reduction by shape), so a caller
    that needs the integer codes compares them on its own.
    """
    from repro_torch.serve import Router, RouterConfig, poisson_trace

    class _Clock:
        """Adapter reading through the injectable obs timer
        (``repro_torch.obs.timer``) so the deterministic-clock tests
        control the router too."""

        def now(self) -> float:
            return obs_timer.now()

        def sleep(self, seconds: float) -> None:
            if seconds > 0:
                obs_timer.sleep(seconds)

    queries = [np.asarray(make_query(i)) for i in range(n_queries)]
    submit = getattr(compiled, "submit_wave", None)
    for w in range(max(warmup, 0)):
        if submit is None:
            break
        y, _ = submit(queries[w % n_queries][None],
                      micro_batch=micro_batch)
        _ready(y)                              # build and warm the wave
    cfg = RouterConfig(max_wait_ms=max_wait_ms, micro_batch=micro_batch,
                       p99_budget_ms=p99_budget_ms)
    router = Router({"m": compiled}, cfg, clock=_Clock(),
                    service_models=(None if service_model is None
                                    else {"m": service_model}),
                    tracer=tracer, engine=engine)
    pool = router.lanes["m"].pool
    if submit is not None and warmup > 0 \
            and any(r.stream is not None for r in pool.replicas):
        # a replica's CUDA stream pays one-time costs on its first wave
        pool.warm(queries[0][None], micro_batch=micro_batch)
    trace = poisson_trace(qps=qps, n=n_queries, seed=seed)
    reqs = router.run_trace("m", trace, lambda i: queries[i])
    served = [r for r in reqs if not r.shed]
    shed = len(reqs) - len(served)
    lats = [r.latency_s for r in served] or [0.0]
    span = (max(r.done_t for r in served) - min(r.arrival_t for r in served)
            if served else 1e-9)
    snap = router.stats()["m"]["metrics"]
    exact = None
    if served and hasattr(compiled, "offline"):
        xb = np.stack([r.x for r in served])
        y_ref = _host(compiled.offline(xb))
        got = np.stack([np.asarray(r.result) for r in served])
        exact = bool(np.array_equal(got, y_ref)) if np.issubdtype(
            y_ref.dtype, np.integer) else bool(
            np.allclose(got, y_ref, rtol=1e-6, atol=1e-6))
    extras = dict(offered_qps=qps, served=len(served), shed=shed,
                  shed_rate=shed / max(len(reqs), 1),
                  micro_batch=router.lanes["m"].micro_batch,
                  wave_occupancy=snap.mean_occupancy,
                  n_waves=snap.n_waves)
    if p99_budget_ms is not None:
        extras["p99_budget_ms"] = p99_budget_ms
        extras["met_slo"] = bool(served) and bool(np.percentile(
            np.asarray(lats) * 1e3, 99) <= p99_budget_ms)
    if exact is not None:
        extras["bit_exact_vs_offline"] = exact
    return _finish("ServerStreaming", lats, len(served), span,
                   model_cost, bits, **extras)


def run_all_scenarios(infer: Callable, make_query: Callable[[int], np.ndarray],
                      n_queries: int = 64, n_streams: int = 8,
                      offline_samples: int = 256, server_qps: float = 200.0,
                      model_cost=None, bits: int = 8, compiled=None,
                      tracer=None) -> List[ScenarioReport]:
    """The MLPerf-Tiny sweep for one deployed model: SingleStream,
    MultiStream, Offline and Server; StreamingOffline when ``compiled``
    has ``streaming_compiled``, and ServerStreaming (the Server load
    through the dynamic-batching router) when it has ``submit_wave``."""
    reports = [
        single_stream(infer, make_query, n_queries=n_queries,
                      model_cost=model_cost, bits=bits, compiled=compiled,
                      tracer=tracer),
        multi_stream(infer, make_query, n_streams=n_streams,
                     n_queries=n_queries, model_cost=model_cost, bits=bits,
                     tracer=tracer),
        offline(infer, make_query, n_samples=offline_samples,
                model_cost=model_cost, bits=bits, compiled=compiled,
                tracer=tracer),
        server_poisson(infer, make_query, qps=server_qps,
                       n_queries=n_queries, model_cost=model_cost, bits=bits,
                       tracer=tracer),
    ]
    if compiled is not None and hasattr(compiled, "streaming_compiled"):
        reports.append(streaming_pipeline(
            compiled, make_query, n_samples=offline_samples,
            model_cost=model_cost, bits=bits, tracer=tracer))
    if compiled is not None and hasattr(compiled, "submit_wave"):
        reports.append(server_streaming(
            compiled, make_query, qps=server_qps, n_queries=n_queries,
            model_cost=model_cost, bits=bits, tracer=tracer))
    return reports
