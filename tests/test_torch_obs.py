"""The port's trace exporters and span reports (``repro_torch.obs.export``,
``repro_torch.obs.report``) against the reference's.

Both packages record the same scripted events under one fake timer (a
clock that ticks a fixed step per reading): the Chrome trace and the
JSONL export are the same bytes, with the port's span args carrying torch
scalars and 0-d tensors where the reference's carry the equal numpy
scalars. The report functions give the reference's numbers on the same
events. The port's executor, traced under the fake timer, exports the
same bytes on every run.
"""

import json

import numpy as np
import pytest
import torch

from repro.obs import export as jexport
from repro.obs import report as jreport
from repro.obs import timer as jtimer
from repro.obs.tracer import Tracer as JTracer
from repro_torch import obs as tobs
from repro_torch.bench.models import KWS_BITS, mlp_graph
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.obs import export as texport
from repro_torch.obs import report as treport
from repro_torch.obs import timer as ttimer
from repro_torch.obs.tracer import Tracer as TTracer
from _torch_threads import one_torch_thread  # noqa: F401


class TickClock:
    """A fake timer: every reading advances time by ``step`` seconds."""

    def __init__(self, step: float = 0.000125, start: float = 2.0):
        self.t, self.step = start, step

    def now(self) -> float:
        self.t += self.step
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


class Stable:
    """An arg whose text form is stable (no address in its repr)."""

    def __str__(self):
        return "stable-object"


def _args(torchy: bool, i: int):
    """Span args: the port's side carries torch scalars and 0-d tensors
    where the reference's carries the equal numpy scalars."""
    if torchy:
        f32 = torch.tensor(0.1 * (i + 1), dtype=torch.float32)
        i32 = torch.tensor(i * 7 - 3, dtype=torch.int32)
        i64 = torch.tensor(2 ** 40 + i)
        b = torch.tensor(i % 2 == 0)
        f64 = torch.tensor(1.0 / 3.0 + i, dtype=torch.float64)
    else:
        f32 = np.float32(0.1 * (i + 1))
        i32 = np.int32(i * 7 - 3)
        i64 = np.int64(2 ** 40 + i)
        b = np.bool_(i % 2 == 0)
        f64 = np.float64(1.0 / 3.0 + i)
    return {"f32": f32, "i32": i32, "i64": i64, "flag": b, "f64": f64,
            "list": [i32, "x", f32, 3, Stable()], "tuple": (b, 1.5),
            "obj": Stable(), "none": None, "text": f"stage{i}"}


def _record(tracer, torchy: bool):
    """The same scripted events on either package's tracer: spans through
    the context manager and from explicit readings, instants, counters
    (the port's value a 0-d tensor), pids and tids."""
    for i in range(4):
        with tracer.span("stage", cat="executor", pid=1, tid=i,
                         **_args(torchy, i)) as sp:
            sp.set(extra=(torch.tensor(i) if torchy else np.int64(i)))
            tracer.instant("fire", cat="fifo", pid=1, tid=i, k=i)
        t0 = tracer.now()
        tracer.add_span("wave", t0, tracer.now(), cat="serve", pid=2,
                        args={"model": "kws", "platform": "torch-cpu",
                              "micro_batch": 16, "n_valid": 11 + i,
                              7: "an int key",
                              "predicted_ms": (torch.tensor(0.25 + i)
                                               if torchy
                                               else np.float32(0.25 + i))})
        v = 0.5 * i
        tracer.counter("backlog", torch.tensor(v) if torchy else np.float32(v),
                       pid=0)
    tracer.add_span("empty_args", 1.0, 1.5)


NAMES = dict(process_names={0: "router", 1: "replica0", 2: "waves"},
             thread_names={(1, 0): "lane0", (1, 1): "lane1"})


def _pair(capacity=1 << 16, timer_clock=True):
    """(reference tracer, port tracer) with the same events recorded under
    their own fake timers, or on explicit clocks."""
    if timer_clock:
        jt, tt = JTracer(capacity=capacity), TTracer(capacity=capacity)
        with jtimer.fake(TickClock()):
            _record(jt, torchy=False)
        with ttimer.fake(TickClock()):
            _record(tt, torchy=True)
    else:
        jt = JTracer(clock=TickClock(), capacity=capacity)
        tt = TTracer(clock=TickClock(), capacity=capacity)
        _record(jt, torchy=False)
        _record(tt, torchy=True)
    return jt, tt


@pytest.mark.parametrize("timer_clock", [True, False])
@pytest.mark.parametrize("capacity", [1 << 16, 7])
def test_chrome_and_jsonl_exports_are_the_references_bytes(
        tmp_path, timer_clock, capacity):
    """Chrome trace JSON and JSONL: the same bytes as the reference's,
    as strings and as files, with metadata names and ``meta``; a small
    ring buffer (events dropped) too."""
    jt, tt = _pair(capacity, timer_clock)
    assert len(tt) == len(jt) > 0 and tt.n_dropped == jt.n_dropped
    meta = {"card": "none", "rows": np.int64(3)}
    tmeta = {"card": "none", "rows": torch.tensor(3)}
    assert texport.chrome_json(tt, meta=tmeta, **NAMES) == \
        jexport.chrome_json(jt, meta=meta, **NAMES)
    assert texport.jsonl_lines(tt) == jexport.jsonl_lines(jt)
    pt = texport.export_chrome(tt, str(tmp_path / "t" / "trace.json"),
                               meta=tmeta, **NAMES)
    pj = jexport.export_chrome(jt, str(tmp_path / "j" / "trace.json"),
                               meta=meta, **NAMES)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    qt = texport.export_jsonl(tt, str(tmp_path / "t" / "trace.jsonl"))
    qj = jexport.export_jsonl(jt, str(tmp_path / "j" / "trace.jsonl"))
    assert open(qt, "rb").read() == open(qj, "rb").read()
    doc = json.loads(open(pt).read())
    if capacity > 100:
        assert {e["ph"] for e in doc["traceEvents"]} == {"M", "X", "i", "C"}


def test_sanitize_unwraps_torch_scalars_like_numpy_scalars():
    """0-d tensors of every dtype family become the JSON primitive the
    reference writes for the equal numpy scalar; other tensors stringify;
    no arg gives ``None``."""
    pairs = [(torch.tensor(1.5), np.float32(1.5)),
             (torch.tensor(0.1, dtype=torch.float64), np.float64(0.1)),
             (torch.tensor(0.1), np.float32(0.1)),
             (torch.tensor(-3, dtype=torch.int32), np.int32(-3)),
             (torch.tensor(2 ** 62), np.int64(2 ** 62)),
             (torch.tensor(True), np.bool_(True)),
             (torch.tensor(7, dtype=torch.uint8), np.uint8(7))]
    for t, n in pairs:
        got = texport._sanitize({"v": t, "l": [t]})
        want = jexport._sanitize({"v": n, "l": [n]})
        assert got == want and type(got["v"]) is type(want["v"])
        assert json.dumps(got) == json.dumps(want)
    assert texport._sanitize(None) is None and texport._sanitize({}) is None
    assert texport._sanitize({"t": torch.ones(2)})["t"] == str(torch.ones(2))


def _report_events(tracer, torchy: bool):
    """Request, wave and stage spans as the serving instrumentation names
    them, on explicit clock readings."""
    rng = np.random.default_rng(4)
    t = 0.0
    for i in range(40):
        dur = float(rng.uniform(0.0005, 0.004))
        args = {"uid": i, "model": "kws" if i % 3 else "ad"}
        if i % 11 == 5:
            args["shed"] = True
        tracer.add_span(treport.REQUEST_SPAN, t, t + dur, args=args)
        pred = 0.8 * dur * 1e3
        tracer.add_span(treport.WAVE_SPAN, t, t + dur * 1.1, args={
            "model": args["model"], "platform": "gpu" if i % 2 else "cpu",
            "micro_batch": 16, "n_valid": 5 + i % 11,
            "predicted_ms": torch.tensor(pred, dtype=torch.float64)
            if torchy else np.float64(pred)})
        tracer.add_span(treport.STAGE_SPAN, t, t + dur / 3,
                        args={"stage": f"dense{i % 3}"})
        t += dur
    tracer.add_span(treport.WAVE_SPAN, 0.0, 1.0, args={"model": "x"})


def test_report_functions_equal_the_references(tmp_path):
    jt, tt = JTracer(), TTracer()
    _report_events(jt, torchy=False)
    _report_events(tt, torchy=True)
    for model in (None, "kws", "ad", "absent"):
        np.testing.assert_array_equal(
            treport.request_latencies_ms(tt, model),
            jreport.request_latencies_ms(jt, model))
        assert treport.latency_percentiles(tt, model) == \
            jreport.latency_percentiles(jt, model)
    assert treport.prediction_records(tt) == jreport.prediction_records(jt)
    assert len(treport.prediction_records(tt)) == 40
    assert treport.prediction_error(tt) == jreport.prediction_error(jt)
    assert treport.stage_medians_ms(tt) == jreport.stage_medians_ms(jt)
    pt = treport.export_prediction_records(tt, str(tmp_path / "t.jsonl"))
    pj = jreport.export_prediction_records(jt, str(tmp_path / "j.jsonl"))
    assert open(pt, "rb").read() == open(pj, "rb").read()
    assert (treport.REQUEST_SPAN, treport.WAVE_SPAN, treport.STAGE_SPAN) == \
        (jreport.REQUEST_SPAN, jreport.WAVE_SPAN, jreport.STAGE_SPAN)


def test_obs_package_exports_the_references_names():
    import repro.obs as jobs

    for name in ("chrome_events", "chrome_json", "export_chrome",
                 "export_jsonl", "jsonl_lines", "export_prediction_records",
                 "latency_percentiles", "prediction_error",
                 "prediction_records", "request_latencies_ms",
                 "stage_medians_ms", "Tracer", "NullTracer", "NULL_TRACER"):
        assert hasattr(jobs, name) and hasattr(tobs, name), name


def _traced_executor_run():
    """KWS at a small width on the CPU, traced under a fake timer: stage
    probes, streaming through the host queues and compiled segments."""
    g = mlp_graph((24, 16, 16, 4), KWS_BITS, 3, name="kws")
    x = np.random.default_rng(1).integers(-3, 4, (12, 24)).astype(np.int32)
    tracer = TTracer()
    with ttimer.fake(TickClock()):
        cm = tcompile(g, device="cpu", tracer=tracer)
        cm.stage_latencies(x, iters=2)
        cm.streaming_host(x, micro_batch=4)
        cm.streaming_compiled(x, micro_batch=4)
    return tracer


def test_executor_trace_exports_the_same_bytes_every_run(tmp_path):
    a, b = _traced_executor_run(), _traced_executor_run()
    assert len(a) > 0
    assert {e.name for e in a.events()} >= {"stage", "fire", "segment"}
    pa = tobs.export_chrome(a, str(tmp_path / "a.json"))
    pb = tobs.export_chrome(b, str(tmp_path / "b.json"))
    assert open(pa, "rb").read() == open(pb, "rb").read()
    assert tobs.jsonl_lines(a) == tobs.jsonl_lines(b)
    doc = json.loads(open(pa).read())
    assert doc["otherData"]["n_dropped"] == 0
    assert all(e["ph"] in ("X", "i", "C") for e in doc["traceEvents"])
