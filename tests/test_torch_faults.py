"""The port's fault plane (``repro_torch.serve.faults``) against the
reference's: fault specs and plans, the integrity guard on numpy arrays
and torch tensors, the hand-simulated failure runs of the reference's
``tests/test_faults.py`` (wave timeouts, crashes, quarantine and probes,
corrupt outputs, retries, slowdowns, drains that must end), the seeded
chaos run's byte-identical event log, and ``FaultyModel`` on the port's
compiled executor.

Every run goes through both packages under a ``ManualClock`` with each
side's scripted pool and tracer, and the two must agree to the bit
(``observe`` and ``run_both`` in ``test_torch_serve.py``).
"""

import math

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro.serve.faults as jfaults
import repro_torch.serve as tserve
import repro_torch.serve.faults as tfaults
from test_torch_serve import (
    PORT,
    REF,
    ScriptedModel,
    _golden_pair,
    observe,
    run_both,
    traced_router,
)
from _torch_threads import one_torch_thread  # noqa: F401


def _svc(ns, service_s):
    return ns.ServiceModel(works=[("s", 0)], sec_per_cycle=service_s / 9)


def _x(i=1):
    return np.full((4,), i, np.int32)       # scripted row sum = 4*i


# ---------------------------------------------------------------------------
# specs, plans, chaos plans
# ---------------------------------------------------------------------------

def test_fault_vocabulary_and_spec_validation_equal_reference():
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults.DEFAULT_OUTPUT_BOUND == jfaults.DEFAULT_OUTPUT_BOUND
    for m in (jserve, tserve):
        with pytest.raises(ValueError, match="unknown fault kind"):
            m.FaultSpec("power_surge", wave=1)
        with pytest.raises(ValueError, match="needs a key"):
            m.FaultSpec("replica_crash")
        with pytest.raises(ValueError, match="factor"):
            m.FaultSpec("replica_slowdown", wave=1, factor=0.0)
    for name in ("WaveError", "WaveTimeout", "ReplicaCrashed",
                 "TransientSubmitError", "CorruptWave", "NoReplicaAvailable"):
        assert issubclass(getattr(tserve, name), tserve.FaultError)
    assert issubclass(tserve.FaultError, RuntimeError)


def test_executor_and_serve_share_the_fault_classes():
    """The executor raises the serving stack's own ``WaveError``: one
    class object, which the router catches as a ``FaultError``."""
    from repro_torch.deploy import executor

    assert executor.WaveError is tserve.WaveError is tfaults.WaveError


def _plan_script(ns):
    plan = ns.FaultPlan([
        ns.FaultSpec("transient_submit_error", replica=0, wave=2),
        ns.FaultSpec("replica_slowdown", replica=1, after_t=0.01,
                     until_t=0.02, factor=3.0),
        ns.FaultSpec("corrupt_output", replica=1, after_t=0.0, n_times=2),
    ])
    seen = []
    for rep, wave, now in ((0, 1, 0.0), (1, 2, 0.0), (0, 2, 0.0),
                           (0, 2, 0.0), (1, 9, 0.009), (1, 9, 0.01),
                           (1, 10, 0.015), (1, 11, 0.02), (1, 12, 0.5)):
        seen.append([repr(f) for f in plan.active(rep, wave, now)])
    plan.reset()
    seen.append([repr(f) for f in plan.active(0, 2, 0.0)])
    return seen, repr(plan)


def test_fault_plan_matching_and_consumption_equal_reference():
    ref, port = _plan_script(REF), _plan_script(PORT)
    assert port == ref
    seen = port[0]
    assert seen[2] and not seen[3]            # consumed once
    assert seen[-1]                           # re-armed by reset


@pytest.mark.parametrize("seed", [0, 11, 42, 43])
def test_chaos_plan_equals_reference(seed):
    j = jserve.FaultPlan.chaos(seed=seed, n_replicas=3, horizon_s=1.0,
                               n_faults=6)
    t = tserve.FaultPlan.chaos(seed=seed, n_replicas=3, horizon_s=1.0,
                               n_faults=6)
    assert [repr(s) for s in t.specs] == [repr(s) for s in j.specs]
    assert repr(t) == repr(j)


# ---------------------------------------------------------------------------
# the integrity guard: numpy and torch
# ---------------------------------------------------------------------------

I32_MIN = np.iinfo(np.int32).min

GUARD_CASES = [
    (np.zeros((2, 3), np.float32), {}),
    (np.full((2,), 2.0 ** 24), {}),
    (np.asarray([1.0, np.inf], np.float32), {}),
    (np.asarray([1.0, -np.inf]), {}),
    (np.asarray([1.0, np.nan], np.float32), {}),
    (np.asarray([2.0 ** 26], np.float32), {}),
    (np.asarray([-(1 << 26)], np.int64), {}),
    (np.asarray([[3, I32_MIN]], np.int32), {}),
    (np.asarray([I32_MIN], np.int32), {"bound": 2.0 ** 31}),
    (np.asarray([I32_MIN + 1, 5], np.int32), {"bound": 2.0 ** 31 - 1}),
    (np.asarray([np.iinfo(np.int32).max], np.int32), {}),
    (np.asarray([-(1 << 24), 1 << 24], np.int32), {}),
    (np.zeros((0,), np.float32), {}),
    (np.zeros((0, 4), np.int32), {}),
    (np.asarray([100.0]), {"bound": 100.0}),
    (np.asarray([101.0], np.float32), {"bound": 100.0}),
    (np.asarray([True, False]), {}),
    (np.asarray([7, -9], np.int8), {"bound": 8.0}),
]


@pytest.mark.parametrize("i", range(len(GUARD_CASES)))
def test_wave_integrity_guard_equals_reference_on_numpy_and_torch(i):
    y, kw = GUARD_CASES[i]
    want = jfaults.wave_integrity_ok(y, **kw)
    assert tfaults.wave_integrity_ok(y, **kw) is want
    assert tfaults.wave_integrity_ok(torch.from_numpy(y.copy()), **kw) is want


def test_guard_casts_before_abs_where_int32_abs_wraps():
    """torch's int32 ``abs`` wraps INT32_MIN onto itself (a negative
    number, which any bound would pass); the guard casts to float64
    first, as the reference's numpy does."""
    t = torch.tensor([I32_MIN], dtype=torch.int32)
    assert int(t.abs().max()) == I32_MIN             # the trap
    assert not tfaults.wave_integrity_ok(t)
    assert not jfaults.wave_integrity_ok(t.numpy())


# ---------------------------------------------------------------------------
# hand-simulated failure runs (tests/test_faults.py's), both packages
# ---------------------------------------------------------------------------

def _async_run(services, plan_specs, config, n=2, xs=None, svc=None,
               pre=None):
    """A scripted pool under a plan, requests at t=0, drained."""
    def run(ns):
        clock = ns.ManualClock()
        plan = ns.FaultPlan([ns.FaultSpec(**s) for s in plan_specs])
        pool = ns.scripted_pool(clock, services, plan=plan)
        if pre is not None:
            pre(ns, pool)
        router, tracer, _ = traced_router(
            ns, {"m": pool}, ns.RouterConfig(**config),
            service_models=None if svc is None else {"m": _svc(ns, svc)},
            engine=ns.AsyncEngine(), clock=clock)
        reqs = [router.submit("m", _x(1 if xs is None else xs[i]),
                              arrival_t=0.0) for i in range(n)]
        router.drain()
        return observe(ns, router, reqs, tracer,
                       [(r.health, r.last_failure, r.n_failures,
                         r.model.n_attempts, len(r.model.calls))
                        for r in pool.replicas])
    return run


def _quarantine(pre_state):
    def pre(ns, pool):
        pool.replicas[0].health = getattr(ns, pre_state)
        pool.replicas[0].next_probe_t = 10.0
    return pre


FAULT_SCENARIOS = {
    "wave_timeout_retried_elsewhere": _async_run(
        [0.010, 0.010], [dict(kind="wave_timeout", replica=0, wave=1)],
        dict(max_wait_ms=1.0, wave_timeout_mult=3.0, retry_backoff_ms=0.5,
             max_retries=2), svc=0.010),
    "result_before_deadline_is_served": _async_run(
        [0.010], [], dict(max_wait_ms=1.0, wave_timeout_mult=3.0),
        svc=0.010),
    "crash_mid_burst_loses_nothing": _async_run(
        [0.010, 0.010],
        [dict(kind="replica_crash", replica=0, wave=2, duration_s=0.05)],
        dict(max_wait_ms=1.0, retry_backoff_ms=0.5), n=8,
        xs=list(range(8))),
    "fully_quarantined_pool_sheds": _async_run(
        [0.010], [], dict(max_wait_ms=1.0),
        pre=_quarantine("QUARANTINED")),
    "corrupt_output_retried": _async_run(
        [0.010, 0.010], [dict(kind="corrupt_output", replica=0, wave=1)],
        dict(max_wait_ms=1.0, retry_backoff_ms=0.5), xs=[3, 3]),
    "integrity_check_off_serves_corrupt": _async_run(
        [0.010], [dict(kind="corrupt_output", replica=0, wave=1)],
        dict(max_wait_ms=1.0, integrity_check=False)),
    "transient_error_retries_in_place": _async_run(
        [0.010], [dict(kind="transient_submit_error", replica=0, wave=1)],
        dict(max_wait_ms=1.0, retry_backoff_ms=0.5), xs=[2, 2]),
    "retries_exhausted_sheds": _async_run(
        [0.010, 0.010],
        [dict(kind="transient_submit_error", replica=0, after_t=0.0,
              n_times=10),
         dict(kind="transient_submit_error", replica=1, after_t=0.0,
              n_times=10)],
        dict(max_wait_ms=1.0, retry_backoff_ms=0.5, max_retries=2)),
    "slowdown_is_not_a_fault": _async_run(
        [0.010], [dict(kind="replica_slowdown", replica=0, after_t=0.0,
                       factor=3.0)], dict(max_wait_ms=1.0)),
    "drain_ends_with_a_lost_wave": _async_run(
        [0.010], [dict(kind="wave_timeout", replica=0, wave=1)],
        dict(max_wait_ms=1.0, retry_backoff_ms=0.5)),
    "drain_ends_when_every_retry_is_lost": _async_run(
        [0.010], [dict(kind="wave_timeout", replica=0, after_t=0.0,
                       n_times=50)],
        dict(max_wait_ms=1.0, retry_backoff_ms=0.5, max_retries=5)),
    "admission_priced_to_surviving_pool": _async_run(
        [0.010, 0.010], [], dict(max_wait_ms=2.0, p99_budget_ms=25.0),
        n=6, svc=0.010, pre=_quarantine("QUARANTINED")),
    "probe_due_readmits": _async_run(
        [0.010, 0.010], [], dict(max_wait_ms=1.0), n=6,
        pre=lambda ns, pool: (setattr(pool.replicas[0], "health",
                                      ns.QUARANTINED),
                              setattr(pool.replicas[0], "next_probe_t",
                                      0.0))),
}


@pytest.mark.parametrize("name", sorted(FAULT_SCENARIOS))
def test_fault_run_equals_reference(name):
    run_both(FAULT_SCENARIOS[name])


def test_fault_runs_hand_simulated_on_the_port():
    got = run_both(FAULT_SCENARIOS["wave_timeout_retried_elsewhere"])
    assert got["clock"] == pytest.approx(0.0405)
    assert got["row"]["m"]["faults"] == {"timeout": 1}
    assert got["extra"][0][:2] == ("suspect", "WaveTimeout")
    got = run_both(FAULT_SCENARIOS["crash_mid_burst_loses_nothing"])
    assert not any(got["shed"])
    np.testing.assert_allclose(np.asarray(got["done"]) * 1e3,
                               [10, 10, 10, 10, 30, 30, 20, 20], rtol=1e-9)
    assert [r[0] for r in got["result"]] == [4.0 * i for i in range(8)]
    got = run_both(FAULT_SCENARIOS["corrupt_output_retried"])
    assert got["clock"] == pytest.approx(0.0205)
    assert got["row"]["m"]["faults"] == {"integrity": 1}
    got = run_both(FAULT_SCENARIOS["retries_exhausted_sheds"])
    assert got["row"]["m"]["shed_reasons"] == {"retries_exhausted": 2}
    assert got["row"]["m"]["faults"]["submit_error"] == 3
    got = run_both(FAULT_SCENARIOS["fully_quarantined_pool_sheds"])
    assert got["clock"] == 0.0 and all(e.startswith("no_replica")
                                       for e in got["error"])
    got = run_both(FAULT_SCENARIOS["drain_ends_when_every_retry_is_lost"])
    assert math.isfinite(got["clock"]) and all(got["shed"])


def _quarantine_cycle(ns):
    """Two failures quarantine replica 0; one probe wave after the probe
    interval readmits it (``tests/test_faults.py``'s cycle)."""
    clock = ns.ManualClock()
    plan = ns.FaultPlan([ns.FaultSpec("replica_crash", replica=0, wave=1,
                                      duration_s=0.005)])
    pool = ns.scripted_pool(clock, [0.010, 0.010], plan=plan)
    router, tracer, _ = traced_router(
        ns, {"m": pool}, ns.RouterConfig(max_wait_ms=1.0,
                                         retry_backoff_ms=1.0, max_retries=3,
                                         probe_interval_ms=20.0),
        engine=ns.AsyncEngine(), clock=clock)
    r0 = pool.replicas[0]
    seen, reqs = [], []
    reqs += [router.submit("m", _x(), arrival_t=0.0) for _ in range(2)]
    seen.append(r0.health)
    clock.advance(0.001)
    router.step()
    reqs += [router.submit("m", _x(), arrival_t=clock.now())
             for _ in range(2)]
    seen += [r0.health, r0.next_probe_t, pool.n_available]
    router.drain()
    seen.append(r0.health)
    if clock.now() < 0.025:
        clock.advance(0.025 - clock.now())
    reqs += [router.submit("m", _x(), arrival_t=clock.now())
             for _ in range(2)]
    seen.append(r0.health)
    router.drain()
    seen += [r0.health, r0.n_failures, pool.n_available,
             len(r0.model.calls)]
    return observe(ns, router, reqs, tracer, seen)


def _failed_probe(ns):
    clock = ns.ManualClock()
    plan = ns.FaultPlan([ns.FaultSpec("replica_crash", replica=0, wave=1,
                                      duration_s=math.inf)])
    pool = ns.scripted_pool(clock, [0.010, 0.010], plan=plan)
    router, tracer, _ = traced_router(
        ns, {"m": pool}, ns.RouterConfig(max_wait_ms=1.0,
                                         retry_backoff_ms=1.0, max_retries=3,
                                         probe_interval_ms=10.0),
        engine=ns.AsyncEngine(), clock=clock)
    r0 = pool.replicas[0]
    reqs = [router.submit("m", _x(), arrival_t=0.0) for _ in range(2)]
    clock.advance(0.001)
    router.step()
    reqs += [router.submit("m", _x(), arrival_t=clock.now())
             for _ in range(2)]
    first = r0.next_probe_t
    router.drain()
    while clock.now() < first:
        clock.advance(first - clock.now())
    reqs += [router.submit("m", _x(), arrival_t=clock.now())
             for _ in range(2)]
    router.drain()
    return observe(ns, router, reqs, tracer,
                   (first, r0.health, r0.next_probe_t, len(r0.model.calls)))


def test_quarantine_probe_cycles_equal_reference():
    got = run_both(_quarantine_cycle)["extra"]
    assert got == ["suspect", "quarantined", pytest.approx(0.021), 1,
                   "quarantined", "recovering", "healthy", 0, 2, 1]
    first, health, nxt, calls = run_both(_failed_probe)["extra"]
    assert health == "quarantined" and nxt > first and calls == 0


def test_place_on_fully_quarantined_pool_raises_like_reference():
    msgs = []
    for ns in (REF, PORT):
        pool = ns.scripted_pool(ns.ManualClock(), [0.010])
        pool.replicas[0].health = ns.QUARANTINED
        pool.replicas[0].next_probe_t = 10.0
        with pytest.raises(ns.NoReplicaAvailable,
                           match="replica0=quarantined") as e:
            pool.place(0.0, now=0.0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _chaos_run(seed):
    def run(ns):
        clock = ns.ManualClock()
        plan = ns.FaultPlan.chaos(seed=seed, n_replicas=2, horizon_s=0.08,
                                  n_faults=5)
        pool = ns.scripted_pool(clock, [0.003, 0.003], plan=plan)
        router, tracer, _ = traced_router(
            ns, {"m": pool}, ns.RouterConfig(max_wait_ms=2.0,
                                             wave_timeout_mult=3.0,
                                             retry_backoff_ms=0.5,
                                             max_retries=2),
            service_models={"m": _svc(ns, 0.003)}, engine=ns.AsyncEngine(),
            clock=clock)
        reqs = router.run_trace("m", ns.poisson_trace(qps=300.0, n=40,
                                                      seed=5),
                                lambda i: _x(i))
        return observe(ns, router, reqs, tracer, repr(plan))
    return run


@pytest.mark.parametrize("seed", [11, 3, 7, 2022])
def test_chaos_run_event_log_is_the_references_bytes(seed):
    """A seeded chaos plan over two scripted replicas with deadlines and
    retries: the port's Chrome JSON is the reference's, byte for byte,
    and replaying it gives the same bytes again."""
    got = run_both(_chaos_run(seed))
    again = _chaos_run(seed)(PORT)
    assert again["chrome"] == got["chrome"]
    for shed, res in zip(got["shed"], got["result"]):
        assert shed or res is not None                 # a verdict each
    if seed == 11:
        assert sum(got["row"]["m"]["faults"].values()) > 0


# ---------------------------------------------------------------------------
# FaultyModel on the real submit_wave path
# ---------------------------------------------------------------------------

def _faulty_golden(ns, cm, x, plan_specs, engine):
    clock = ns.ManualClock()
    plan = ns.FaultPlan([ns.FaultSpec(**s) for s in plan_specs])
    pool = ns.faulty_pool(ns.ReplicaPool(cm), plan, clock=clock)
    router, tracer, _ = traced_router(
        ns, {"kws": pool}, ns.RouterConfig(max_wait_ms=1.0, micro_batch=2,
                                           retry_backoff_ms=0.5),
        engine=getattr(ns, engine)(), clock=clock)
    reqs = [router.submit("kws", x[i], arrival_t=0.0)
            for i in range(x.shape[0])]
    router.drain()
    fm = pool.replicas[0].model
    return observe(ns, router, reqs, tracer,
                   (fm.n_injected, fm.n_attempts,
                    pool.default_micro_batch == cm.default_micro_batch))


@pytest.mark.parametrize("engine", ["SyncEngine", "AsyncEngine"])
@pytest.mark.parametrize("kind", ["corrupt_output", "transient_submit_error",
                                  "replica_crash", "wave_timeout"])
def test_faulty_model_on_the_compiled_executor_equals_reference(kind,
                                                                engine):
    """``faulty_pool`` around each side's compiled KWS golden: the fault
    fires on the first wave, the router retries it, and the served rows
    equal ``offline`` (logits within 1e-5) and the reference's; the fault
    counts, timing and trace agree."""
    jm, tm, x = _golden_pair("kws")
    x = x[:2]                                       # one wave
    spec = [dict(kind=kind, replica=0, wave=1, duration_s=0.0005)]
    jo = _faulty_golden(REF, jm, x, spec, engine)
    to = _faulty_golden(PORT, tm, x, spec, engine)
    np.testing.assert_allclose(np.asarray(to["result"], np.float32),
                               tm.offline(x).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(to["result"]),
                               np.asarray(jo["result"]), rtol=1e-5,
                               atol=1e-5)
    for k in ("uid", "done", "latency", "shed", "error", "row", "clock",
              "chrome", "extra"):
        assert to[k] == jo[k], k
    assert not any(to["shed"])
    assert to["extra"] == (1, 2, True)


def test_faulty_model_corrupts_integer_codes_without_touching_the_wave():
    """On an integer (headless) executor the corrupt wave is a clone
    pushed past 2**26 (the executor's own output is untouched), the guard
    rejects it, and a slowdown stretches the wave by its measured time
    on the injected clock."""
    import dataclasses

    from repro_torch.deploy import CompiledTinyModel

    _, tm, x = _golden_pair("ad")
    head = CompiledTinyModel(dataclasses.replace(
        tm.schedule, stages=tm.schedule.stages[:-1]), device="cpu")
    clean, _ = head.submit_wave(x[:2], micro_batch=2)
    clock = tserve.ManualClock()
    plan = tserve.FaultPlan([tserve.FaultSpec("corrupt_output", replica=0,
                                              wave=1)])
    fm = tserve.FaultyModel(head, plan, clock=clock)
    y, mask = fm.submit_wave(x[:2], micro_batch=2)
    assert isinstance(y, torch.Tensor) and y.dtype == torch.int32
    assert torch.equal(y[:, 1:], clean[:, 1:])
    assert torch.equal(y[:, 0], clean[:, 0] + (1 << 26))
    assert not tserve.wave_integrity_ok(y[:2])
    assert tserve.wave_integrity_ok(head.submit_wave(x[:2],
                                                     micro_batch=2)[0])

    class Timed(ScriptedModel):
        pass

    for ns in (REF, PORT):
        clock = ns.ManualClock()
        slow = ns.FaultyModel(Timed(clock, service_s=0.004, micro_batch=2),
                              ns.FaultPlan([ns.FaultSpec(
                                  "replica_slowdown", replica=0,
                                  after_t=0.0, factor=2.5)]), clock=clock)
        slow.submit_wave(np.ones((2, 3)), micro_batch=2)
        assert clock.now() == pytest.approx(0.004 * 2.5)


def test_faulty_model_crash_outage_expires_like_reference():
    class _Echo:
        default_micro_batch = 4

        def submit_wave(self, x, valid=None, micro_batch=None):
            x = np.asarray(x)
            mb = int(micro_batch or self.default_micro_batch)
            n = x.shape[0]
            mask = np.concatenate([np.ones(n, bool), np.zeros(mb - n, bool)])
            y = np.zeros((mb,) + x.shape[1:], np.float32)
            y[:n] = x
            return y, mask

    for ns, faults in ((REF, jfaults), (PORT, tfaults)):
        clock = ns.ManualClock()
        plan = ns.FaultPlan([ns.FaultSpec("replica_crash", replica=0,
                                          wave=1, duration_s=0.5)])
        fm = ns.FaultyModel(_Echo(), plan, replica=0, clock=clock)
        with pytest.raises(faults.ReplicaCrashed):
            fm.submit_wave(np.ones((2, 3)))
        clock.advance(0.2)
        with pytest.raises(faults.ReplicaCrashed, match="down until"):
            fm.submit_wave(np.ones((2, 3)))
        clock.advance(0.4)
        _, mask = fm.submit_wave(np.ones((2, 3)))
        assert mask.tolist() == [True, True, False, False]
        assert fm.n_attempts == 3


def test_faulty_model_reads_the_obs_timer_without_a_clock():
    from repro_torch.obs import timer

    clock = tserve.ManualClock(start=3.0)
    with timer.fake(clock):
        fm = tserve.FaultyModel(ScriptedModel(clock, 0.001, 2),
                                tserve.FaultPlan([tserve.FaultSpec(
                                    "replica_crash", replica=0, after_t=2.5,
                                    duration_s=1.0)]))
        with pytest.raises(tserve.ReplicaCrashed, match="t=3.000000"):
            fm.submit_wave(np.ones((1, 2)), micro_batch=2)
        assert fm.crashed_until == 4.0


def test_executor_wraps_execution_failures_as_wave_error():
    _, tm, x = _golden_pair("kws")
    _, mask = tm.submit_wave(x[:2], micro_batch=4)
    assert mask.tolist() == [True, True, False, False]
    tm.segments = None
    with pytest.raises(tserve.WaveError, match="compiled segment pipeline"):
        tm.submit_wave(x[:2], micro_batch=4)
    _, tm2, _ = _golden_pair("kws")
    with pytest.raises(ValueError):
        tm2.submit_wave(x[:3], micro_batch=2)
