"""The port's MLPerf-Tiny scenarios (``repro_torch.deploy.scenarios``)
against the reference's under one deterministic clock.

Both packages read time only through their injectable timers
(``repro.obs.timer``, ``repro_torch.obs.timer``); one fake clock installed
in both makes every latency exactly computable. The same scripted
service times go through each side's scenario, and the reports must
agree field for field: percentiles, throughput, counts, the stage
breakdown and the extras. The energy fields differ by design (the
reference prices a TPU at 200 W, the port the card at 700 W), so each is
checked against its own side's constants.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import codesign as jcodesign
from repro.core.bops import schedule_cost as jschedule_cost
from repro.deploy import scenarios as jsc
from repro.obs import timer as jtimer
from repro_torch.core import codesign as tcodesign
from repro_torch.core.bops import schedule_cost as tschedule_cost
from repro_torch.core.qir import Graph as TGraph
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.deploy import scenarios as tsc
from repro_torch.obs import timer as ttimer
from _torch_threads import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


class FakeClock:
    """now/sleep stand-in: time only moves when told to."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def sleep(self, s: float):
        assert s >= 0
        self.t += s

    def advance(self, s: float):
        self.t += s


@pytest.fixture()
def clock():
    ck = FakeClock()
    with jtimer.fake(ck), ttimer.fake(ck):
        yield ck


def _mk(i):
    return np.zeros((4,), np.int32)


def _scripted(clock, times, out=lambda x: np.zeros((x.shape[0], 2))):
    """An infer that advances the clock by the next scripted time."""
    it = iter(times)

    def infer(x):
        clock.advance(next(it))
        return out(np.asarray(x))
    return infer


def _run_both(clock, fn_name, times, **kw):
    """The same scenario on each side, each from clock 0 with its own copy
    of the scripted times; returns (reference report, port report)."""
    reps = []
    for mod in (jsc, tsc):
        clock.t = 0.0
        reps.append(getattr(mod, fn_name)(_scripted(clock, list(times)),
                                          _mk, **kw))
    return reps


def _same_report(j, t):
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    for k in ("energy_proxy_uJ", "measured_energy_uJ"):
        jd.pop(k)
        td.pop(k)
    assert td == jd
    # the measured energies: one median latency, each side's power
    assert t.measured_energy_uJ / tcodesign.CHIP_WATTS == pytest.approx(
        j.measured_energy_uJ / jcodesign.CHIP_WATTS, rel=1e-12)
    assert (t.energy_proxy_uJ is None) == (j.energy_proxy_uJ is None)


def test_single_stream_equal_reference(clock):
    service = [0.001] * 3 + [0.004, 0.002, 0.010, 0.001, 0.003, 0.005,
                             0.007, 0.006]
    j, t = _run_both(clock, "single_stream", service, n_queries=8, warmup=3)
    _same_report(j, t)
    expect = np.asarray(service[3:]) * 1e3
    assert t.p90_ms == pytest.approx(float(np.percentile(expect, 90)))
    assert t.throughput_qps == pytest.approx(8 / sum(service[3:]))
    assert t.measured_energy_uJ == pytest.approx(
        float(np.median(service[3:])) * 700.0 * 1e6)


def test_multi_stream_equal_reference(clock):
    j, t = _run_both(clock, "multi_stream", [0.005] * 4, n_streams=4,
                     n_queries=12, warmup=1)
    _same_report(j, t)
    assert t.extras == {"streams": 4}


def test_offline_equal_reference(clock):
    spans = [0.010, 0.010, 0.090, 0.032, 0.001]
    j, t = _run_both(clock, "offline", spans, n_samples=32, warmup=2,
                     iters=3)
    _same_report(j, t)
    assert t.p50_ms == pytest.approx(0.032 / 32 * 1e3)
    assert t.extras == {"batch": 32, "iters": 3}


def test_server_poisson_equal_reference(clock):
    qps, n, seed, service = 250.0, 24, 3, 0.007
    j, t = _run_both(clock, "server_poisson", [service] * (n + 3), qps=qps,
                     n_queries=n, seed=seed, warmup=2)
    _same_report(j, t)
    arrivals = np.cumsum(np.random.default_rng(seed).exponential(1 / qps, n))
    done, expect = 0.0, []
    for a in arrivals:
        done = max(a, done) + service
        expect.append(done - a)
    assert t.p99_ms == pytest.approx(
        float(np.percentile(np.asarray(expect) * 1e3, 99)))


def test_streaming_pipeline_equal_reference(clock):
    calls = []

    class FakeStats:
        micro_batch = 8
        fifo_depths = [2, 2]
        segments = [(0, 2)]

    class FakeCompiled:
        def streaming_compiled(self, xb, micro_batch=None):
            calls.append(micro_batch)
            clock.advance(0.016)
            return np.zeros((xb.shape[0], 2), np.float32), FakeStats()

    reps = []
    for mod in (jsc, tsc):
        clock.t = 0.0
        reps.append(mod.streaming_pipeline(FakeCompiled(), _mk, n_samples=16,
                                           warmup=1, iters=3))
    _same_report(*reps)
    assert calls == [None] * 8
    assert reps[1].extras["micro_batch"] == 8


def test_stage_breakdown_and_roofline_energy_against_each_side(clock):
    """Offline with a compiled model attached: the stage rows come from the
    model's probe; the roofline energy is each side's ``deploy_report`` of
    the same schedule cost."""

    class FakeCompiled:
        def stage_latencies(self, x, iters=2):
            return [{"stage": "s0", "kind": "K", "ms": 1.0},
                    {"stage": "s1", "kind": "K", "ms": 2.0}]

    with open(os.path.join(GOLDEN_DIR, "kws.qir.json")) as f:
        tg = TGraph.from_json(f.read())
    from repro.core.qir import Graph as JGraph
    from repro.deploy import compile_graph as jcompile

    jg = JGraph.from_json(tg.to_json())
    jcost = jschedule_cost(jcompile(jg, use_pallas=False).schedule.stages)
    tcost = tschedule_cost(tcompile(tg, device="cpu").schedule.stages)
    reps = []
    for mod, cost in ((jsc, jcost), (tsc, tcost)):
        clock.t = 0.0
        reps.append(mod.offline(_scripted(clock, [0.004] * 4), _mk,
                                n_samples=8, warmup=1, compiled=FakeCompiled(),
                                model_cost=cost, bits=3))
    j, t = reps
    _same_report(j, t)
    assert t.row()["stage_ms"] == "s0:1.000|s1:2.000"
    assert t.energy_proxy_uJ == tcodesign.deploy_report(
        tcost, batch=1, bits=3)["energy_uJ"]
    assert j.energy_proxy_uJ == jcodesign.deploy_report(
        jcost, batch=1, bits=3)["energy_uJ"]
    assert t.energy_proxy_uJ != j.energy_proxy_uJ


def test_run_all_scenarios_on_a_compiled_golden(clock):
    """The sweep on a real compiled model on the CPU (its stage probes and
    streaming path run; the fake clock makes the numbers exact): the
    reference's scenarios, ServerStreaming (through the port's router)
    last, its served results equal to ``offline``."""
    with open(os.path.join(GOLDEN_DIR, "kws.qir.json")) as f:
        tg = TGraph.from_json(f.read())
    cm = tcompile(tg, device="cpu")
    x = np.random.default_rng(0).integers(-127, 128, (16, 490)).astype(
        np.int32)

    def infer(xb):
        clock.advance(0.001)
        return cm.offline(xb)

    reps = tsc.run_all_scenarios(infer, lambda i: x[i % 16], n_queries=8,
                                 n_streams=4, offline_samples=16,
                                 server_qps=100.0,
                                 model_cost=tschedule_cost(cm.schedule.stages),
                                 compiled=cm)
    assert [r.scenario for r in reps] == ["SingleStream", "MultiStream",
                                          "Offline", "Server",
                                          "StreamingOffline",
                                          "ServerStreaming"]
    assert reps[-1].extras["bit_exact_vs_offline"] is True
    assert reps[-1].extras["served"] == 8
    assert reps[0].p90_ms == pytest.approx(1.0)
    assert reps[0].stage_ms and len(reps[0].stage_ms) == len(
        cm.schedule.stages)
    assert reps[-2].extras["micro_batch"] == cm.default_micro_batch
    assert all(r.energy_proxy_uJ is not None for r in reps)


class _WaveFake:
    """A ``submit_wave`` executor advancing the fake clock by a scripted
    service time per wave, with an ``offline`` the check reads."""

    default_micro_batch = 2

    def __init__(self, clock, service_s):
        self.clock, self.service_s, self.waves = clock, service_s, []

    def submit_wave(self, x, valid=None, micro_batch=None):
        mb = int(micro_batch or self.default_micro_batch)
        x = np.asarray(x)
        n = x.shape[0]
        self.waves.append(n)
        self.clock.advance(self.service_s)
        mask = np.concatenate([np.ones(n, bool), np.zeros(mb - n, bool)])
        y = np.zeros((mb, 2), np.float32)
        y[:n] = x.reshape(n, -1)[:, :2] * 0.5
        return y, mask

    def offline(self, x):
        return np.asarray(x).reshape(len(x), -1)[:, :2] * 0.5


def _mk_varied(i):
    return np.arange(4, dtype=np.int32) + i


def test_server_streaming_waits_for_the_serving_stack(clock):
    """``server_streaming`` drives the port's router now: under one fake
    timer the reference and the port give the same report, field for
    field — batching waits, percentiles, throughput, waves, occupancy,
    the offline check — with and without an SLO budget (energy fields
    checked against each side's own constants)."""
    from repro.serve import ServiceModel as JService
    from repro_torch.serve import ServiceModel as TService

    for kw in (dict(qps=250.0, n_queries=9, seed=4, max_wait_ms=6.0,
                    micro_batch=2, warmup=1),
               dict(qps=500.0, n_queries=40, seed=0, max_wait_ms=2.0,
                    micro_batch=2, warmup=0, p99_budget_ms=120.0),
               dict(qps=90.0, n_queries=17, seed=2, max_wait_ms=3.0,
                    warmup=2)):
        reps, waves = [], []
        for mod, service in ((jsc, JService), (tsc, TService)):
            clock.t = 0.0
            fake = _WaveFake(clock, 0.050 if "p99_budget_ms" in kw
                             else 0.0)
            svc = (service(works=[("s", 0)], sec_per_cycle=0.050 / 9)
                   if "p99_budget_ms" in kw else None)
            reps.append(mod.server_streaming(fake, _mk_varied,
                                             service_model=svc, **kw))
            waves.append(fake.waves)
        j, t = reps
        assert waves[1] == waves[0]
        assert t.scenario == j.scenario == "ServerStreaming"
        assert (t.n_queries, t.p50_ms, t.p90_ms, t.p99_ms,
                t.throughput_qps) == (j.n_queries, j.p50_ms, j.p90_ms,
                                      j.p99_ms, j.throughput_qps)
        assert t.extras == j.extras
        assert t.extras["bit_exact_vs_offline"] is True
        if "p99_budget_ms" in kw:
            assert 0 < t.extras["shed"] < kw["n_queries"]


def test_server_streaming_keeps_ad_logits_bit_exact_vs_offline(clock):
    """The float head's sum does not depend on the row count: the
    full-width AD autoencoder (logits up to 1e4) served through the router
    in 8-row waves gives the logits of one ``offline`` call on all the
    served rows, so ``bit_exact_vs_offline`` (the reference's 1e-6) holds.
    On the card the head is ``ops.float_head``, whose per-output reduction
    order is fixed (``tests/test_torch_cuda.py``); here its plain
    version."""
    from repro_torch.bench.models import AD_BITS, AD_DIMS, mlp_graph

    cm = tcompile(mlp_graph(AD_DIMS, AD_BITS, 2024), in_scale=1.0 / 127.0,
                  device="cpu")
    rng = np.random.default_rng(0)
    xs = rng.integers(-127, 128, (64, AD_DIMS[0])).astype(np.int32)
    rep = tsc.server_streaming(cm, lambda i: xs[i], qps=500.0, n_queries=64,
                               seed=3, micro_batch=8, warmup=0)
    assert rep.extras["served"] == 64 and rep.extras["n_waves"] >= 8
    assert rep.extras["bit_exact_vs_offline"] is True
    assert float(cm.offline(xs).abs().max()) > 100.0


def test_ready_passes_cpu_and_numpy_outputs_through():
    y = torch.ones(3)
    assert tsc._ready(y) is y
    pair = (np.zeros(2), "stats")
    assert tsc._ready(pair) is pair
