"""The port's serving stack (``repro_torch.serve``) against the reference's
(``repro.serve``): traffic, metrics, the synchronous router, replica
placement, the SLO controller and the golden-model padded-wave contract.

Every timing-shaped run is an exact discrete-event simulation under a
``ManualClock`` with scripted service times, traced by each side's own
``Tracer``. The same script runs through both packages, and the runs must
agree to the bit: per-request latencies, completion times, verdicts and
results, every ``MetricsSnapshot`` field and ``row()``, the rest of
``Router.stats()``, and the Chrome trace JSON of the whole run. The
hand-worked numbers of the reference's own tests are checked on the port
beside that. The golden section serves the four Table-1 goldens through
both routers on the CPU: codes bit for bit, logits within 1e-5. The other
two files of this group (``test_torch_serve_async.py``,
``test_torch_faults.py``) import their harness from here.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.serve as jserve
import repro.serve.replica as jreplica
import repro.serve.sim as jsim
import repro_torch.obs as tobs
import repro_torch.serve as tserve
import repro_torch.serve.replica as treplica
import repro_torch.serve.sim as tsim
from repro.core.qir import Graph as JGraph
from repro.deploy import compile_graph as jcompile
from repro_torch.core.qir import Graph as TGraph
from repro_torch.deploy import compile_graph as tcompile
from _torch_threads import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
MODELS = ("kws", "ad", "ic", "cnv")


def _side(serve, sim, replica, obs):
    ns = types.SimpleNamespace(**{k: getattr(serve, k) for k in dir(serve)
                                  if not k.startswith("_")})
    ns.scripted_pool = sim.scripted_pool
    ns.ScriptedWaveModel = sim.ScriptedWaveModel
    for k in ("HEALTHY", "SUSPECT", "QUARANTINED", "RECOVERING"):
        setattr(ns, k, getattr(replica, k))
    ns.Tracer, ns.chrome_json = obs.Tracer, obs.chrome_json
    return ns


REF = _side(jserve, jsim, jreplica, jobs)
PORT = _side(tserve, tsim, treplica, tobs)


class ScriptedModel:
    """``submit_wave`` fake with the executor's padding contract (the
    reference's ``tests/test_serve.py`` fake, package-free): each wave
    advances the manual clock by a scripted service time; outputs are the
    row sums of the inputs, so results trace back."""

    def __init__(self, clock, service_s=0.003, micro_batch=4):
        self.clock = clock
        self.service_s = service_s
        self.default_micro_batch = micro_batch
        self.calls = []          # (n_valid, micro_batch) per wave

    def submit_wave(self, x, valid=None, micro_batch=None):
        mb = int(micro_batch or self.default_micro_batch)
        x = np.asarray(x)
        n = x.shape[0]
        assert n <= mb
        mask = np.ones(n, bool) if valid is None else np.asarray(valid, bool)
        mask = np.concatenate([mask, np.zeros(mb - n, bool)])
        self.calls.append((int(mask.sum()), mb))
        s = self.service_s(len(self.calls)) if callable(self.service_s) \
            else self.service_s
        self.clock.advance(s)
        y = np.zeros((mb, 1), np.float32)
        y[:n, 0] = x.reshape(n, -1).sum(axis=1)
        return y, mask


def observe(ns, router, reqs, tracer, extra=None):
    """Everything a run shows: per-request timing, verdicts and results,
    each lane's snapshot (every field and ``row()``), the rest of
    ``stats()`` (the replicas' device names apart), the clock, and the
    Chrome JSON of the run's trace."""
    stats = router.stats()
    return {
        "uid": [r.uid for r in reqs],
        "arrival": [r.arrival_t for r in reqs],
        "done": [r.done_t for r in reqs],
        "latency": [r.latency_s for r in reqs],
        "shed": [r.shed for r in reqs],
        "error": [r.error for r in reqs],
        "result": [None if r.result is None else np.asarray(r.result).tolist()
                   for r in reqs],
        "snapshot": {k: dataclasses.asdict(v["metrics"])
                     for k, v in stats.items()},
        "row": {k: v["metrics"].row() for k, v in stats.items()},
        "stats": {k: {kk: vv for kk, vv in v.items() if kk != "metrics"}
                  for k, v in stats.items()},
        # the device each replica names: the port's model-only pool sits
        # on the model's own device ("cpu"), the reference's on "local"
        "devices": [[r.pop("device") for r in v["replicas"]]
                    for v in stats.values()],
        "clock": router.clock.now(),
        "chrome": ns.chrome_json(tracer, **router.trace_names()),
        "extra": extra,
    }


def run_both(scenario):
    """``scenario(ns)`` on the reference and on the port; asserts the two
    observations are equal and returns the port's."""
    ref, port = scenario(REF), scenario(PORT)
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k] == ref[k], k
    return port


def traced_router(ns, models, config=None, service_models=None,
                  engine=None, clock=None):
    """A router over ``models`` with a ``Tracer`` on its manual clock."""
    clock = clock if clock is not None else ns.ManualClock()
    tracer = ns.Tracer(clock=clock)
    router = ns.Router(models, config, clock=clock,
                       service_models=service_models, tracer=tracer,
                       engine=engine)
    return router, tracer, clock


# ---------------------------------------------------------------------------
# traffic: the same arrays for the same seeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gen,args", [
    ("poisson_trace", dict(qps=100.0, n=500, seed=7)),
    ("poisson_trace", dict(qps=3.5e5, n=2048, seed=0)),
    ("mmpp_trace", dict(qps_states=(10.0, 1000.0), dwell_s=0.5, n=2000,
                        seed=0)),
    ("mmpp_trace", dict(qps_states=(50.0, 500.0, 5.0), dwell_s=0.1, n=300,
                        seed=3)),
    ("diurnal_trace", dict(qps_low=5.0, qps_high=200.0, period_s=4.0,
                           n=400, seed=1)),
])
def test_traffic_generators_equal_reference(gen, args):
    j, t = getattr(jserve, gen)(**args), getattr(tserve, gen)(**args)
    assert t.arrivals.dtype == j.arrivals.dtype == np.float64
    np.testing.assert_array_equal(t.arrivals, j.arrivals)
    assert (t.kind, t.meta, t.n, t.span_s, t.offered_qps) == \
        (j.kind, j.meta, j.n, j.span_s, j.offered_qps)
    js, ts = j.scaled(2.5), t.scaled(2.5)
    np.testing.assert_array_equal(ts.arrivals, js.arrivals)
    assert ts.meta == js.meta
    assert set(tserve.GENERATORS) == set(jserve.GENERATORS)


def test_replay_trace_and_validation_equal_reference():
    raw = [5.0, 5.5, 7.0, 6.25]
    j, t = jserve.replay_trace(raw, meta={"src": "x"}), \
        tserve.replay_trace(raw, meta={"src": "x"})
    np.testing.assert_array_equal(t.arrivals, j.arrivals)
    np.testing.assert_allclose(t.arrivals, [0.0, 0.5, 1.25, 2.0])
    for bad in (lambda m: m.poisson_trace(qps=0.0, n=4),
                lambda m: m.mmpp_trace((), dwell_s=1.0, n=4),
                lambda m: m.diurnal_trace(10.0, 5.0, 1.0, 4),
                lambda m: m.replay_trace([1.0]).scaled(0.0),
                lambda m: m.Trace("x", np.asarray([1.0, 0.5]))):
        for m in (jserve, tserve):
            with pytest.raises(ValueError):
                bad(m)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _metrics_script(ns):
    m = ns.ServeMetrics(window_s=10.0, start_t=-3.0)
    snaps = [m.snapshot(0.0)]
    for i in range(10):
        m.record_admit(0.5 * i)
        m.record_completion(0.5 * i + 0.25, 0.001 * (i + 1) + 1e-7 * i)
    for t, reason in ((4.0, "slo"), (4.5, "no_replica"), (11.0, "slo"),
                      (12.0, "retries_exhausted")):
        m.record_shed(t, reason)
    for t, kind in ((1.0, "timeout"), (9.0, "integrity"), (10.0, "crash")):
        m.record_fault(t, kind)
    m.record_wave(1.0, 4, 4, 0.003)
    m.record_wave(2.0, 2, 4)
    m.record_wave(9.5, 3, 8, 0.0041)
    for now in (5.0, 10.0, 11.0, 14.5, 19.5, 40.0):
        snaps.append(m.snapshot(now))
    return [(dataclasses.asdict(s), s.row()) for s in snaps]


def test_metrics_window_snapshots_and_rows_equal_reference():
    ref, port = _metrics_script(REF), _metrics_script(PORT)
    assert port == ref
    snap, row = port[2]                    # now = 10: nothing pruned yet
    assert snap["n_completed"] == 10 and snap["occupancy_hist"] == {
        4: 1, 2: 1, 3: 1}
    assert row["shed_reasons"] == {"slo": 2, "no_replica": 1,
                                   "retries_exhausted": 1}
    assert port[-1][0]["n_completed"] == 0          # all out of the window


# ---------------------------------------------------------------------------
# the synchronous router under a manual clock (tests/test_serve.py's runs)
# ---------------------------------------------------------------------------

def _full_wave_then_deadline(ns):
    clock = ns.ManualClock()
    model = ScriptedModel(clock, service_s=0.0, micro_batch=4)
    router, tracer, _ = traced_router(ns, {"m": model},
                                      ns.RouterConfig(max_wait_ms=5.0), clock=clock)
    x = np.ones((8,), np.int32)
    reqs = [router.submit("m", x) for _ in range(3)]
    steps = [len(model.calls)]
    router.step()
    clock.advance(0.0049)
    steps += [router.step(), len(model.calls)]
    clock.advance(0.0002)
    steps += [router.step(), list(model.calls)]
    reqs += [router.submit("m", x) for _ in range(4)]
    return observe(ns, router, reqs, tracer, (steps, model.calls))


def _deadline_anchors_to_oldest(ns):
    clock = ns.ManualClock()
    model = ScriptedModel(clock, service_s=0.0, micro_batch=8)
    router, tracer, _ = traced_router(ns, {"m": model},
                                      ns.RouterConfig(max_wait_ms=10.0),
                                      clock=clock)
    reqs = [router.submit("m", np.ones((2,), np.int32))]
    clock.advance(0.008)
    reqs.append(router.submit("m", np.ones((2,), np.int32)))
    dl = router.next_deadline()
    clock.advance(0.002)
    served = router.step()
    return observe(ns, router, reqs, tracer, (dl, served, model.calls))


def _hand_trace(ns, engine=None):
    """mb=2, max_wait=5ms, service=3ms/wave, arrivals [0,1,10,11,30] ms:
    latencies [4, 3, 4, 3, 8] ms (worked out in ``tests/test_serve.py``)."""
    clock = ns.ManualClock()
    model = ScriptedModel(clock, service_s=0.003, micro_batch=2)
    router, tracer, _ = traced_router(ns, {"m": model},
                                      ns.RouterConfig(max_wait_ms=5.0),
                                      engine=engine, clock=clock)
    trace = ns.replay_trace(np.asarray([0.0, 1.0, 10.0, 11.0, 30.0]) * 1e-3)
    reqs = router.run_trace("m", trace, lambda i: np.ones((4,), np.int32))
    return observe(ns, router, reqs, tracer, model.calls)


def _svc(ns, service_s):
    """A one-stage ``ServiceModel`` whose waves of up to 8 rows cost
    exactly ``service_s`` (9 modeled cycles each)."""
    return ns.ServiceModel(works=[("s", 0)], sec_per_cycle=service_s / 9)


def _overload_sheds(ns):
    clock = ns.ManualClock()
    mb, service_s = 4, 0.004
    model = ScriptedModel(clock, service_s=service_s, micro_batch=mb)
    router, tracer, _ = traced_router(
        ns, {"m": model}, ns.RouterConfig(max_wait_ms=2.0,
                                          p99_budget_ms=25.0),
        service_models={"m": _svc(ns, service_s)}, clock=clock)
    trace = ns.poisson_trace(qps=2 * mb / service_s, n=400, seed=3)
    reqs = router.run_trace("m", trace, lambda i: np.full((4,), i % 7,
                                                          np.int32))
    return observe(ns, router, reqs, tracer, model.calls)


def _below_saturation(ns):
    clock = ns.ManualClock()
    mb, service_s = 4, 0.004
    model = ScriptedModel(clock, service_s=service_s, micro_batch=mb)
    router, tracer, _ = traced_router(
        ns, {"m": model}, ns.RouterConfig(max_wait_ms=10.0,
                                          p99_budget_ms=50.0),
        service_models={"m": _svc(ns, service_s)}, clock=clock)
    trace = ns.poisson_trace(qps=0.5 * mb / service_s, n=200, seed=5)
    reqs = router.run_trace("m", trace, lambda i: np.ones((4,), np.int32))
    return observe(ns, router, reqs, tracer)


def _bursty_heterogeneous(ns):
    """An MMPP burst trace through a budgeted lane whose scripted service
    varies by wave (heterogeneous wave costs)."""
    clock = ns.ManualClock()
    model = ScriptedModel(clock, service_s=lambda k: 0.002 + 0.001 * (k % 3),
                          micro_batch=4)
    router, tracer, _ = traced_router(
        ns, {"m": model}, ns.RouterConfig(max_wait_ms=3.0,
                                          p99_budget_ms=15.0,
                                          slo_headroom=0.8),
        service_models={"m": _svc(ns, 0.003)}, clock=clock)
    trace = ns.mmpp_trace((100.0, 4000.0), dwell_s=0.02, n=300, seed=9)
    reqs = router.run_trace("m", trace, lambda i: np.full((3,), i, np.int32))
    return observe(ns, router, reqs, tracer, model.calls)


def _spreads_across_replicas(ns):
    clock = ns.ManualClock()
    pool = ns.ReplicaPool(factory=lambda: ScriptedModel(clock, 0.001, 2),
                          devices=[None, None])
    router, tracer, _ = traced_router(
        ns, {"m": pool}, ns.RouterConfig(max_wait_ms=1.0,
                                         p99_budget_ms=100.0),
        service_models={"m": _svc(ns, 0.001)}, clock=clock)
    reqs = [router.submit("m", np.ones((2,), np.int32)) for _ in range(8)]
    return observe(ns, router, reqs, tracer,
                   [r.n_dispatched for r in pool.replicas])


def _two_lanes_diurnal(ns):
    """Two lanes with their own configs; a diurnal trace on one, a Poisson
    trace on the other, then a flush and drain."""
    clock = ns.ManualClock()
    a = ScriptedModel(clock, service_s=0.002, micro_batch=3)
    b = ScriptedModel(clock, service_s=0.001, micro_batch=2)
    router, tracer, _ = traced_router(
        ns, {"a": a, "b": b},
        {"a": ns.RouterConfig(max_wait_ms=4.0),
         "b": ns.RouterConfig(max_wait_ms=1.0, p99_budget_ms=8.0)},
        service_models={"b": _svc(ns, 0.001)}, clock=clock)
    reqs = router.run_trace("a", ns.diurnal_trace(20.0, 900.0, 0.2, 120,
                                                  seed=2),
                            lambda i: np.full((2,), i, np.int32))
    reqs += router.run_trace("b", ns.poisson_trace(700.0, 90, seed=4),
                             lambda i: np.full((2,), -i, np.int32))
    return observe(ns, router, reqs, tracer, (a.calls, b.calls))


SYNC_SCENARIOS = {
    "full_wave_inline_partial_at_deadline": _full_wave_then_deadline,
    "deadline_anchors_to_oldest_request": _deadline_anchors_to_oldest,
    "hand_simulated_trace": _hand_trace,
    "overload_sheds": _overload_sheds,
    "no_shedding_below_saturation": _below_saturation,
    "bursty_heterogeneous_waves": _bursty_heterogeneous,
    "spreads_across_replicas": _spreads_across_replicas,
    "two_lanes_diurnal_and_poisson": _two_lanes_diurnal,
}


@pytest.mark.parametrize("name", sorted(SYNC_SCENARIOS))
def test_sync_router_run_equals_reference(name):
    run_both(SYNC_SCENARIOS[name])


def test_hand_simulated_trace_latencies_on_the_port():
    got = run_both(_hand_trace)
    np.testing.assert_allclose(np.asarray(got["latency"]) * 1e3,
                               [4.0, 3.0, 4.0, 3.0, 8.0], rtol=1e-9)
    assert got["extra"] == [(2, 2), (2, 2), (1, 2)]
    row = got["row"]["m"]
    assert row["occupancy"] == round((1 + 1 + 0.5) / 3, 3)
    assert row["p99_ms"] == round(float(np.percentile(
        [4.0, 3.0, 4.0, 3.0, 8.0], 99)), 4)


def test_overload_sheds_and_keeps_served_under_budget_on_the_port():
    got = run_both(_overload_sheds)
    served = [lat for lat, shed in zip(got["latency"], got["shed"])
              if not shed]
    assert 0.25 < 1 - len(served) / 400 < 0.75
    assert max(served) * 1e3 <= 25.0 + 1e-6
    assert got["stats"]["m"]["slo"]["utilization"] > 1.0


def test_full_wave_and_deadline_steps_on_the_port():
    got = run_both(_full_wave_then_deadline)
    steps, calls = got["extra"]
    assert steps == [0, 0, 0, 3, [(3, 4)]]
    assert calls == [(3, 4), (4, 4)]


def test_unknown_lane_and_pool_validation_equal_reference():
    for ns in (REF, PORT):
        router = ns.Router({"m": ScriptedModel(ns.ManualClock())})
        with pytest.raises(KeyError, match="unknown model 'nope'"):
            router.submit("nope", np.zeros((2,), np.int32))
        with pytest.raises(ValueError, match="factory"):
            ns.ReplicaPool(ScriptedModel(ns.ManualClock()),
                           devices=[None, None])
        with pytest.raises(ValueError, match="need a model or a factory"):
            ns.ReplicaPool()
        with pytest.raises(ValueError, match="probe_interval_s"):
            ns.ReplicaPool(ScriptedModel(ns.ManualClock()),
                           probe_interval_s=0.0)


def _placement(ns):
    clock = ns.ManualClock()
    pool = ns.ReplicaPool(factory=lambda: ScriptedModel(clock),
                          devices=[None, None, None])
    picks = [pool.place(work_s=w).index for w in (5.0, 1.0, 1.0, 0.5)]
    pool.complete(pool.replicas[0], 5.0)
    picks.append(pool.place(work_s=0.1).index)
    pool.mark_failure(pool.replicas[1], 0.0, "x")
    pool.mark_failure(pool.replicas[1], 0.01, "y")
    picks += [pool.place(0.2, now=0.02).index,
              pool.place(0.2, now=0.07, exclude=(2,)).index,
              pool.place(0.2, now=0.08, exclude=(0, 2)).index]
    return picks, pool.stats(), pool.n_available


def test_replica_placement_and_health_equal_reference():
    ref, port = _placement(REF), _placement(PORT)
    assert port == ref
    assert port[0][:5] == [0, 1, 2, 1, 0]


def test_pool_without_a_card_raises_and_a_cpu_model_stays_on_the_cpu():
    """``devices=None`` with a factory means every CUDA device; without
    one the pool raises instead of falling back. A model-only pool is one
    replica on the model's own device (no stream on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.ReplicaPool(factory=lambda: ScriptedModel(None))
    cm = tcompile(TGraph.load(os.path.join(GOLDEN_DIR, "kws.qir.json")),
                  device="cpu")
    pool = tserve.ReplicaPool(cm)
    (r,) = pool.replicas
    assert r.device == torch.device("cpu") and r.stream is None
    assert pool.stats()[0]["device"] == "cpu"


# ---------------------------------------------------------------------------
# SLO controller and service models
# ---------------------------------------------------------------------------

def _slo_script(ns):
    out = []
    works = [("a", 490 * 256), ("b", 256 * 256), ("c", 1 << 20), ("d", 0)]
    svc = ns.ServiceModel(works=works, sec_per_cycle=3.7e-9,
                          calibration={"probe_batch": 8})
    for mb in (1, 2, 3, 4, 8, 16, 32, 64, 100):
        out.append((svc.wave_cycles(mb), svc.wave_service_s(mb),
                    svc.saturation_qps(mb)))
    rec = svc.recalibrated(0.0021, 16)
    out.append((rec.sec_per_cycle, rec.calibration, rec.wave_service_s(4)))
    out.append(svc.recalibrated(0.0, 16) is svc)
    for budget in (0.05, 0.3, 1.0, 10.0):
        out.append(ns.slo_operating_point(svc, budget))
        out.append(ns.slo_operating_point(rec, budget, candidates=(64, 3,
                                                                   0, 7)))
    pred = ns.PredictedServiceModel.from_table(works, {4: 0.001, 16: 0.0031,
                                                       64: 0.009})
    for mb in (1, 4, 9, 16, 40, 64, 128):
        out.append(pred.wave_service_s(mb))
    prec = pred.recalibrated(0.004, 16)
    out.append((prec.scale, prec.calibration, prec.wave_service_s(9)))
    ctl = ns.SLOController(30.0, svc, window_s=0.5, headroom=0.9,
                           ewma_alpha=0.3)
    for i in range(60):
        t = i * 0.013 + (0.004 if i % 5 == 0 else 0.0)
        ctl.observe_arrival(t)
        if i % 7 == 0:
            ctl.observe_service(8, 0.0009 + 1e-5 * i)
        out.append((ctl.admit(t, i % 5, 8, 0.002, lag_s=0.001 * (i % 3),
                              n_workers=1 + i % 3),
                    ctl.estimated_latency_s(i % 5, 8, 0.002),
                    ctl.arrival_qps(t), ctl.utilization(t, 8),
                    ctl.occupancy_estimate(t, 8, 0.002),
                    ctl.wave_service_s(8)))
    out.append([ns.queued_waves(p, mb, f) for p in range(9)
                for mb in (1, 2, 4) for f in (0, 1, 3)])
    return out


def test_slo_arithmetic_equals_reference():
    ref, port = _slo_script(REF), _slo_script(PORT)
    assert port == ref
    assert all(type(v) is float for v in port[0][1:])   # Python floats
    for m in (jserve, tserve):
        with pytest.raises(ValueError):
            m.SLOController(0.0, None)
        with pytest.raises(ValueError):
            m.queued_waves(1, 0)
        with pytest.raises(ValueError):
            m.queued_waves(-1, 4)


def _golden_pair(name, megakernel=False):
    """(reference, port) compiled models of one golden graph on the CPU,
    and its input rows."""
    path = os.path.join(GOLDEN_DIR, f"{name}.qir.json")
    x = np.load(os.path.join(GOLDEN_DIR, f"{name}.golden.npz"))["x"]
    jg, tg = JGraph.load(path), TGraph.load(path)
    jm = jcompile(jg, in_scale=jg.meta["in_scale"], use_pallas=False,
                  megakernel=megakernel)
    tm = tcompile(tg, in_scale=tg.meta["in_scale"], device="cpu",
                  megakernel=megakernel)
    return jm, tm, x


def _fixed_stage_ms(cm):
    return [{"stage": s.name, "kind": type(s).__name__,
             "ms": 0.0125 * (i + 1) + 0.003 * (i % 2)}
            for i, s in enumerate(cm.schedule.stages)]


@pytest.mark.parametrize("name", MODELS)
def test_slo_micro_batch_and_service_model_equal_reference(name):
    """``slo_micro_batch`` and ``ServiceModel.from_compiled`` on a compiled
    golden with a fixed ``stage_ms``: the same works, calibration,
    operating point and candidate table as the reference's."""
    from repro.deploy.autotune import slo_micro_batch as jslo
    from repro_torch.deploy.autotune import slo_micro_batch as tslo

    jm, tm, _ = _golden_pair(name)
    stage_ms = _fixed_stage_ms(tm)
    assert [s.name for s in jm.schedule.stages] == \
        [s["stage"] for s in stage_ms]
    for budget in (0.02, 0.09, 0.4, 5.0):
        for probe_batch in (4, 8):
            got = tslo(tm, budget, stage_ms=stage_ms,
                       probe_batch=probe_batch)
            want = jslo(jm, budget, stage_ms=stage_ms,
                        probe_batch=probe_batch)
            assert got == want
    js = jserve.ServiceModel.from_compiled(jm, stage_ms=stage_ms)
    ts = tserve.ServiceModel.from_compiled(tm, stage_ms=stage_ms)
    assert (ts.works, ts.sec_per_cycle, ts.calibration) == \
        (js.works, js.sec_per_cycle, js.calibration)


@pytest.mark.parametrize("name", MODELS)
def test_predicted_service_model_equals_reference_on_staged_schedules(name):
    """Priced by the same predictor artifact from the same features: on
    staged schedules ``wave_features`` is the reference's, so the tables
    are equal (where a K3 run is planned only ``log_residency_bytes``
    differs, ``tests/test_torch_costmodel.py``)."""
    from repro.costmodel import load_default as jload
    from repro_torch.costmodel import load_default as tload

    jm, tm, _ = _golden_pair(name, megakernel=False)
    jp = jserve.PredictedServiceModel.from_predictor(jload(), jm)
    tp = tserve.PredictedServiceModel.from_predictor(tload(), tm)
    assert tp.predicted_s == jp.predicted_s
    assert (tp.works, tp.sec_per_cycle, tp.calibration) == \
        (jp.works, jp.sec_per_cycle, jp.calibration)
    for mb in (1, 3, 8, 48, 64, 100):
        assert tp.wave_service_s(mb) == jp.wave_service_s(mb)


def test_from_compiled_probes_stage_latencies_on_the_port():
    _, tm, _ = _golden_pair("kws")
    svc = tserve.ServiceModel.from_compiled(tm, probe_batch=4)
    assert svc.sec_per_cycle > 0 and type(svc.sec_per_cycle) is float
    assert svc.calibration["probe_batch"] == 4
    assert svc.calibration["modeled_cycles"] == svc.wave_cycles(4)
    assert svc.saturation_qps(32) > svc.saturation_qps(1)
    wave_s = tserve.measure_wave_service_s(tm, 4, iters=3)
    assert type(wave_s) is float and wave_s > 0


# ---------------------------------------------------------------------------
# the golden models through both routers (the acceptance contract)
# ---------------------------------------------------------------------------

def _assert_rows_close(got, want, label):
    got, want = np.asarray(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == want.dtype, label
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=label)


def _serve_golden(ns, cm, name, x, engine):
    clock = ns.ManualClock()
    tracer = ns.Tracer(clock=clock)
    router = ns.Router({name: cm}, ns.RouterConfig(max_wait_ms=1.0,
                                                   micro_batch=3),
                       clock=clock, tracer=tracer, engine=engine)
    rows = np.concatenate([x, x[::-1]])              # 8 rows: 3 + 3 + 2
    reqs = [router.submit(name, rows[i]) for i in range(rows.shape[0])]
    clock.advance(0.002)
    router.step()                                    # the padded partial
    router.drain()
    obs = observe(ns, router, reqs, tracer)
    return obs, rows, np.stack([r.result for r in reqs])


@pytest.mark.parametrize("engine", ["sync", "async"])
@pytest.mark.parametrize("name", MODELS)
def test_router_serves_golden_models_like_reference(name, engine):
    """Full waves and a deadline-flushed padded partial wave of each golden
    through both routers on the CPU: the port's served rows equal the
    reference router's and the port's own ``offline`` (codes bit for bit,
    logits within 1e-5); timing, rows and trace bytes are equal."""
    jm, tm, x = _golden_pair(name, megakernel=None)
    eng = {"sync": "SyncEngine", "async": "AsyncEngine"}[engine]
    jobs_, rows, jy = _serve_golden(REF, jm, name, x,
                                    getattr(jserve, eng)())
    tobs_, _, ty = _serve_golden(PORT, tm, name, x, getattr(tserve, eng)())
    _assert_rows_close(ty, jy, f"{name} port vs reference router")
    _assert_rows_close(ty, tm.offline(rows).numpy(), f"{name} vs offline")
    # the async reference asks JAX's promise arrays ``is_ready`` when it
    # reaps, which races its CPU backend; the port's CPU tensors are ready
    # when returned. So reap order (and with it the trace's event order
    # and the in-flight counters) is compared under the blocking engine
    same = ["uid", "arrival", "done", "latency", "shed", "error",
            "snapshot", "row", "clock"]
    if engine == "sync":
        same += ["stats", "chrome"]
    for k in same:
        assert tobs_[k] == jobs_[k], k
    assert tobs_["snapshot"][name]["occupancy_hist"] == {3: 2, 2: 1}


@pytest.mark.parametrize("name", MODELS)
def test_router_platform_stamp_is_cpu_for_cpu_lanes(name):
    _, tm, x = _golden_pair(name)
    clock = tserve.ManualClock()
    tracer = tobs.Tracer(clock=clock)
    router = tserve.Router({name: tm}, tserve.RouterConfig(micro_batch=2),
                           clock=clock, tracer=tracer)
    assert router.platform == "cpu"
    router.submit(name, x[0])
    router.submit(name, x[1])
    waves = [e for e in tracer.events() if e.name == "wave"]
    assert [e.args["platform"] for e in waves] == ["cpu"]


# ---------------------------------------------------------------------------
# the launcher's tiny stack on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,engine,replicas,autotune", [
    ("kws", "sync", 1, "off"), ("ad", "async", 2, "model"),
    ("kws", "async", 3, "off")])
def test_launch_serve_tiny_stack_on_the_cpu(model, engine, replicas,
                                            autotune, monkeypatch,
                                            tmp_path):
    """``python -m repro_torch.launch.serve --stack tiny --device cpu``:
    every request of the Poisson trace is served through the router over
    ``--replicas`` slots of one executor, and every result equals the
    full-width model's ``offline`` on the same query (logits within
    1e-5)."""
    from repro_torch.bench.models import (AD_BITS, AD_DIMS, KWS_BITS,
                                          KWS_DIMS, mlp_graph)
    from repro_torch.launch.serve import main

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    out = main(["--stack", "tiny", "--device", "cpu", "--tiny-model", model,
                "--engine", engine, "--replicas", str(replicas),
                "--autotune", autotune, "--requests", "40", "--seed", "3"])
    assert out["served"] == out["n"] == 40 and out["device"] == "cpu"
    assert out["replicas"] == replicas and out["p99_ms"] > 0
    dims, bits = (KWS_DIMS, KWS_BITS) if model == "kws" else (AD_DIMS,
                                                              AD_BITS)
    cm = tcompile(mlp_graph(dims, bits, 3, name=model), in_scale=1 / 127,
                  device="cpu")
    reqs = out["requests"]
    want = cm.offline(np.stack([r.x for r in reqs])).numpy()
    np.testing.assert_allclose(np.stack([r.result for r in reqs]), want,
                               rtol=1e-5, atol=1e-5)


def test_launch_serve_lm_stack_on_the_cpu():
    from repro_torch.launch.serve import main

    s = main(["--device", "cpu", "--requests", "3", "--max-new", "3",
              "--slots", "2"])
    assert s["n_requests"] == 3 and s["throughput_tok_s"] > 0
    # deployment quantization is served, not refused (the int8 path)
    q = main(["--device", "cpu", "--requests", "3", "--max-new", "3",
              "--slots", "2", "--quant-bits", "8"])
    assert q["n_requests"] == 3 and q["throughput_tok_s"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--stack", "tiny", "--requests", "2"])


def test_pool_warm_runs_one_wave_on_every_replica():
    clock = tserve.ManualClock()
    models = [ScriptedModel(clock, 0.002, 4) for _ in range(3)]
    it = iter(models)
    pool = tserve.ReplicaPool(factory=lambda: next(it),
                              devices=[None] * 3)
    pool.warm(np.ones((1, 3), np.int32), micro_batch=4)
    assert [m.calls for m in models] == [[(1, 4)]] * 3
    assert [r.n_dispatched for r in pool.replicas] == [0, 0, 0]
    assert clock.now() == pytest.approx(0.006)
