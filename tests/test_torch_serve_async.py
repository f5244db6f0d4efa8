"""The port's dispatch engines against the reference's: async replica
overlap as an exact discrete-event simulation, sync bit-identity, the
placement and admission arithmetic, mask validation and the
``TinyModelServer`` shim.

The harness is each package's ``serve.sim.ScriptedWaveModel``: a fake
executor speaking the ``submit_wave_async`` protocol, whose waves complete
on the manual clock without advancing it. Every run goes through both
packages and must agree to the bit (latencies, completion times, verdicts,
results, snapshots, ``stats()``, Chrome trace JSON; ``observe`` in
``test_torch_serve.py``); the hand-worked numbers of the reference's
``tests/test_serve_async.py`` are checked on the port beside that.
"""

import numpy as np
import pytest

import repro.serve as jserve
import repro_torch.serve as tserve
from test_torch_serve import (
    PORT,
    REF,
    ScriptedModel,
    observe,
    run_both,
    traced_router,
)


def _svc(ns, service_s):
    return ns.ServiceModel(works=[("s", 0)], sec_per_cycle=service_s / 9)


def _x():
    return np.ones((2,), np.int32)


# ---------------------------------------------------------------------------
# overlap, ordering, backpressure
# ---------------------------------------------------------------------------

def _overlap(engine):
    def run(ns):
        clock = ns.ManualClock()
        pool = ns.scripted_pool(clock, [0.003, 0.005])
        router, tracer, _ = traced_router(
            ns, {"m": pool}, ns.RouterConfig(max_wait_ms=1.0),
            engine=getattr(ns, engine)(), clock=clock)
        reqs = [router.submit("m", _x(), arrival_t=0.0) for _ in range(4)]
        router.drain()
        return observe(ns, router, reqs, tracer,
                       [len(r.model.calls) for r in pool.replicas])
    return run


def _single_replica_serializes(ns):
    clock = ns.ManualClock()
    pool = ns.scripted_pool(clock, [0.003])
    router, tracer, _ = traced_router(ns, {"m": pool},
                                      ns.RouterConfig(max_wait_ms=1.0),
                                      engine=ns.AsyncEngine(), clock=clock)
    reqs = [router.submit("m", _x(), arrival_t=0.0) for _ in range(4)]
    router.drain()
    return observe(ns, router, reqs, tracer)


def _event_order(ns):
    clock = ns.ManualClock()
    pool = ns.scripted_pool(clock, [0.005, 0.003])
    router, tracer, _ = traced_router(ns, {"m": pool},
                                      ns.RouterConfig(max_wait_ms=1.0),
                                      engine=ns.AsyncEngine(), clock=clock)
    reqs = [router.submit("m", _x(), arrival_t=0.0) for _ in range(4)]
    router.drain()
    lane = router.lanes["m"]
    return observe(ns, router, reqs, tracer,
                   ([t for t, _ in lane.metrics._completions],
                    [t for t, *_ in lane.metrics._waves]))


def _run_trace_overlap(engine):
    def run(ns):
        clock = ns.ManualClock()
        pool = ns.scripted_pool(clock, [0.010, 0.010])
        router, tracer, _ = traced_router(
            ns, {"m": pool}, ns.RouterConfig(max_wait_ms=5.0),
            engine=getattr(ns, engine)(), clock=clock)
        trace = ns.replay_trace(np.asarray([0.0, 1.0, 2.0, 3.0]) * 1e-3)
        reqs = router.run_trace("m", trace, lambda i: np.ones((4,),
                                                              np.int32))
        return observe(ns, router, reqs, tracer)
    return run


def _backpressure(ns):
    clock = ns.ManualClock()
    pool = ns.scripted_pool(clock, [0.004])
    router, tracer, _ = traced_router(ns, {"m": pool},
                                      ns.RouterConfig(max_wait_ms=1.0),
                                      engine=ns.AsyncEngine(max_inflight=1),
                                      clock=clock)
    reqs = [router.submit("m", _x(), arrival_t=0.0) for _ in range(4)]
    mid = (router.lanes["m"].n_inflight, clock.now())
    router.drain()
    return observe(ns, router, reqs, tracer, mid)


def _sync_default_vs_explicit(ns):
    """The hand-simulated 5-request trace through the default engine and
    through an explicit ``SyncEngine``."""
    outs = []
    for engine in (None, ns.SyncEngine()):
        clock = ns.ManualClock()
        model = ScriptedModel(clock, service_s=0.003, micro_batch=2)
        router, tracer, _ = traced_router(ns, {"m": model},
                                          ns.RouterConfig(max_wait_ms=5.0),
                                          engine=engine, clock=clock)
        trace = ns.replay_trace(np.asarray([0.0, 1.0, 10.0, 11.0, 30.0])
                                * 1e-3)
        reqs = router.run_trace("m", trace,
                                lambda i: np.ones((4,), np.int32))
        outs.append(observe(ns, router, reqs, tracer, model.calls))
    assert outs[0] == outs[1]
    return outs[0]


def _placement_with_service_model(ns):
    clock = ns.ManualClock()
    pool = ns.scripted_pool(clock, [0.005, 0.001])
    router, tracer, _ = traced_router(
        ns, {"m": pool}, ns.RouterConfig(max_wait_ms=1.0),
        service_models={"m": _svc(ns, 0.004)}, engine=ns.AsyncEngine(),
        clock=clock)
    lane = router.lanes["m"]
    seen = [lane.slo is None, lane.work_estimate_s()]
    reqs = [router.submit("m", _x(), arrival_t=0.0) for _ in range(4)]
    r0, r1 = pool.replicas
    seen.append((r0.n_dispatched, r1.n_dispatched, r0.outstanding_s))
    clock.advance(0.002)
    router.step()
    seen.append((r0.n_inflight, r1.n_inflight))
    reqs += [router.submit("m", _x(), arrival_t=clock.now())
             for _ in range(2)]
    seen.append((r0.n_dispatched, r1.n_dispatched, len(r1.model.calls)))
    router.drain()
    seen.append((r0.outstanding_s, r1.outstanding_s))
    return observe(ns, router, reqs, tracer, seen)


def _placement_ewma(ns):
    clock = ns.ManualClock()
    pool = ns.scripted_pool(clock, [0.005, 0.001])
    router, tracer, _ = traced_router(ns, {"m": pool},
                                      ns.RouterConfig(max_wait_ms=1.0),
                                      engine=ns.AsyncEngine(), clock=clock)
    lane = router.lanes["m"]
    seen = [lane.work_estimate_s()]
    reqs = [router.submit("m", _x(), arrival_t=0.0) for _ in range(4)]
    router.drain()
    seen.append((lane.ewma_service_s, lane.work_estimate_s()))
    reqs += [router.submit("m", _x(), arrival_t=clock.now())
             for _ in range(2)]
    seen.append([r.outstanding_s for r in pool.replicas])
    router.drain()
    return observe(ns, router, reqs, tracer, seen)


def _admission(services):
    def run(ns):
        clock = ns.ManualClock()
        pool = ns.scripted_pool(clock, services)
        router, tracer, _ = traced_router(
            ns, {"m": pool}, ns.RouterConfig(max_wait_ms=2.0,
                                             p99_budget_ms=25.0),
            service_models={"m": _svc(ns, 0.010)}, engine=ns.AsyncEngine(),
            clock=clock)
        reqs = [router.submit("m", _x(), arrival_t=0.0) for _ in range(6)]
        router.drain()
        return observe(ns, router, reqs, tracer)
    return run


def _poisson_pool_under_slo(ns):
    """Three heterogeneous replicas under admission and a Poisson trace at
    1.5x the pool's capacity: the async router's whole event loop."""
    clock = ns.ManualClock()
    pool = ns.scripted_pool(clock, [0.004, 0.006, 0.009], micro_batch=4)
    router, tracer, _ = traced_router(
        ns, {"m": pool}, ns.RouterConfig(max_wait_ms=2.5, micro_batch=4,
                                         p99_budget_ms=20.0),
        service_models={"m": _svc(ns, 0.006)},
        engine=ns.AsyncEngine(max_inflight=2), clock=clock)
    cap = sum(4 / s for s in (0.004, 0.006, 0.009))
    reqs = router.run_trace("m", ns.poisson_trace(1.5 * cap, 500, seed=12),
                            lambda i: np.full((3,), i % 11, np.int32))
    return observe(ns, router, reqs, tracer,
                   [len(r.model.calls) for r in pool.replicas])


ASYNC_SCENARIOS = {
    "overlap_async": _overlap("AsyncEngine"),
    "overlap_sync": _overlap("SyncEngine"),
    "single_replica_serializes": _single_replica_serializes,
    "completions_settle_in_event_order": _event_order,
    "run_trace_overlap_async": _run_trace_overlap("AsyncEngine"),
    "run_trace_overlap_sync": _run_trace_overlap("SyncEngine"),
    "backpressure_caps_inflight": _backpressure,
    "sync_engine_equals_default": _sync_default_vs_explicit,
    "placement_charges_service_model": _placement_with_service_model,
    "placement_falls_back_to_ewma": _placement_ewma,
    "admission_counts_inflight_waves": _admission([0.010]),
    "admission_divides_across_workers": _admission([0.010, 0.010]),
    "poisson_heterogeneous_pool_under_slo": _poisson_pool_under_slo,
}


@pytest.mark.parametrize("name", sorted(ASYNC_SCENARIOS))
def test_async_router_run_equals_reference(name):
    run_both(ASYNC_SCENARIOS[name])


def test_overlap_is_max_not_sum_on_the_port():
    a = run_both(_overlap("AsyncEngine"))
    s = run_both(_overlap("SyncEngine"))
    assert a["clock"] == pytest.approx(0.005)
    assert s["clock"] == pytest.approx(0.008)
    np.testing.assert_allclose(a["done"], [0.003, 0.003, 0.005, 0.005])
    np.testing.assert_allclose(s["done"], [0.003, 0.003, 0.008, 0.008])
    assert a["extra"] == s["extra"] == [1, 1]


def test_run_trace_overlap_hand_simulation_on_the_port():
    a = run_both(_run_trace_overlap("AsyncEngine"))
    s = run_both(_run_trace_overlap("SyncEngine"))
    np.testing.assert_allclose(np.asarray(a["latency"]) * 1e3,
                               [11.0, 10.0, 11.0, 10.0], rtol=1e-9)
    np.testing.assert_allclose(np.asarray(s["latency"]) * 1e3,
                               [11.0, 10.0, 19.0, 18.0], rtol=1e-9)
    assert a["row"]["m"]["wave_service_p50_ms"] == 10.0


def test_admission_hand_simulation_on_the_port():
    one = run_both(_admission([0.010]))
    two = run_both(_admission([0.010, 0.010]))
    assert one["shed"] == [False] * 4 + [True] * 2
    assert two["shed"] == [False] * 6
    np.testing.assert_allclose(
        [lat for lat, shed in zip(one["latency"], one["shed"]) if not shed],
        [0.010, 0.010, 0.020, 0.020], rtol=1e-9)
    np.testing.assert_allclose(two["latency"], [0.010] * 4 + [0.020] * 2,
                               rtol=1e-9)


def test_backpressure_and_engine_validation_on_the_port():
    got = run_both(_backpressure)
    assert got["extra"][0] == 1
    assert got["extra"][1] == pytest.approx(0.004)
    assert got["clock"] == pytest.approx(0.008)
    for m in (jserve, tserve):
        with pytest.raises(ValueError, match="max_inflight"):
            m.AsyncEngine(max_inflight=0)


class _LyingModel:
    """Fake executor violating the padding contract: every row of the
    padded wave claims to be valid."""

    default_micro_batch = 4

    def submit_wave(self, x, valid=None, micro_batch=None):
        mb = int(micro_batch or self.default_micro_batch)
        return np.zeros((mb, 1), np.float32), np.ones(mb, bool)


@pytest.mark.parametrize("engine", ["SyncEngine", "AsyncEngine"])
def test_lying_executor_mask_raises_like_reference(engine):
    msgs = []
    for ns in (REF, PORT):
        clock = ns.ManualClock()
        router = ns.Router({"m": _LyingModel()},
                           ns.RouterConfig(max_wait_ms=1.0), clock=clock,
                           engine=getattr(ns, engine)())
        router.submit("m", _x())
        clock.advance(0.002)
        with pytest.raises(RuntimeError, match="mask") as e:
            router.step()
            router.drain()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


class _Echo:
    default_micro_batch = 4

    def submit_wave(self, x, valid=None, micro_batch=None):
        x = np.asarray(x)
        mb = int(micro_batch or self.default_micro_batch)
        n = x.shape[0]
        mask = np.concatenate([np.ones(n, bool), np.zeros(mb - n, bool)])
        y = np.zeros((mb,) + x.shape[1:], x.dtype)
        y[:n] = x * 2
        return y, mask


class _OfflineOnly:
    """A tenant with ``offline`` and no wave API (the adapter's case)."""

    def offline(self, x):
        return np.asarray(x) + 1


@pytest.mark.parametrize("engine", ["SyncEngine", "AsyncEngine"])
def test_tiny_model_server_shim_equals_reference(engine):
    """Two tenants, one through the offline adapter, served by both shims
    under one fake timer: the same results, steps and wave occupancy. The
    reference's router reads ``time.monotonic`` (its ``SystemClock``)
    while the shim stamps ``submit_t`` from the obs timer; the port's
    ``SystemClock`` reads the obs timer too, so only the port's
    completion times follow the fake clock and they are checked alone."""
    from repro.obs import timer as jtimer
    from repro.serving.engine import TinyModelServer as JServer
    from repro_torch.obs import timer as ttimer
    from repro_torch.serving.engine import TinyModelServer as TServer

    outs = []
    for server_cls, ns in ((JServer, REF), (TServer, PORT)):
        clock = ns.ManualClock()
        with jtimer.fake(clock), ttimer.fake(clock):
            server = server_cls({"echo": _Echo(), "plus": _OfflineOnly()},
                                max_batch=4, engine=getattr(ns, engine)())
            reqs = []
            for i in range(11):
                reqs.append(server.submit("echo" if i % 3 else "plus",
                                          np.full((3,), i, np.int32)))
                clock.advance(0.001)
            steps = server.run_until_drained()
            stats = server.stats()
        outs.append(([np.asarray(r.result).tolist() for r in reqs],
                     [(r.uid, r.model, r.submit_t) for r in reqs], steps,
                     {k: (v["n"], v.get("wave_occupancy"))
                      for k, v in stats.items() if k != "_aggregate"},
                     [r.done_t for r in reqs]))
    assert outs[1][:4] == outs[0][:4]
    assert outs[1][4] == [pytest.approx(0.011)] * 11
    for i, res in enumerate(outs[1][0]):
        assert res == [2 * i] * 3 if i % 3 else res == [i + 1] * 3
