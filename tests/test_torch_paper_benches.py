"""The port's paper benches (``repro_torch.bench``: Tables 2, 3 and 6, the
obs and cost-model benches, the harness and the residency check) against
the reference's (``benchmarks/``, ``scripts/``) on the same inputs.

Table 2 gives the reference's rows. Table 3's forwards give the
reference's values on the same numpy parameters, layer by layer from the
same input, and its buffer counts are the reference's. Table 6 runs on the
golden graphs at a few queries: its counts, traffic bytes, modeled cycles
and tuned micro-batch under one scripted probe are the reference's, and
every bit-exact field reads true. The obs bench's guarded sites on the
golden KWS are the reference's spans; the cost-model bench's
leave-one-model-out summary on one fixed table is the reference bench's.
None of these needs a card.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import obs_bench as jobs
from benchmarks import table2_fifo as jt2
from benchmarks import table3_fusion as jt3
from repro.core.bops import schedule_cost as jschedule_cost
from repro.core.dataflow import (BIG_DEPTH, mlp_pipeline_stages,
                                 optimize_fifo_depths)
from repro.costmodel import bootstrap_rows as jbootstrap_rows
from repro.costmodel import leave_one_model_out as jlomo
from repro.deploy import autotune as jat
from repro.deploy import compile_graph as jcompile
from repro.obs.tracer import Tracer as JTracer
from repro_torch.bench import check_megakernel_residency as residency
from repro_torch.bench import costmodel_bench as tcost
from repro_torch.bench import obs_bench as tobs
from repro_torch.bench import run as trun
from repro_torch.bench import table2_fifo as tt2
from repro_torch.bench import table3_fusion as tt3
from repro_torch.bench import table6_scenarios as tt6
from repro_torch.core.qir import Graph as TGraph
from repro_torch.costmodel import bootstrap_rows as tbootstrap_rows
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.deploy import executor as texecutor
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
GOLDENS = ("kws", "ad", "ic", "cnv")
TOL = 1e-5


def _golden_json(name):
    with open(os.path.join(GOLDEN, f"{name}.qir.json")) as f:
        return f.read()


def _pair(name, conv_lowering=None):
    """The golden graph compiled by both packages (the port on the CPU)."""
    from repro.core.qir import Graph as JGraph

    text = _golden_json(name)
    jg, tg = JGraph.from_json(text), TGraph.from_json(text)
    scale = tg.meta["in_scale"]
    return (jcompile(jg, in_scale=scale, use_pallas=False,
                     conv_lowering=conv_lowering),
            tcompile(tg, in_scale=scale, device="cpu",
                     conv_lowering=conv_lowering))


def _pool_maker(tm, seed, n=64):
    """A query maker over a fixed seeded pool: query i is row i mod n."""
    shape = tuple(tt6.default_sample(tm, 1).shape[1:])
    pool = np.random.default_rng(seed).integers(
        -127, 128, (n,) + shape).astype(np.int32)
    return lambda i: pool[i % n], pool


# -- Table 2 ----------------------------------------------------------------

def test_table2_rows_equal_the_reference():
    assert tt2.run() == jt2.run()


# -- Table 3 ----------------------------------------------------------------

def test_table3_buffer_elements_equal_the_reference():
    stages = mlp_pipeline_stages(jt3.DIMS, reuse_factor=4)
    fifo = optimize_fifo_depths(stages, n_tokens=256)
    assert tt3.DIMS == jt3.DIMS
    assert tt3.buffer_elems() == (BIG_DEPTH * (len(stages) + 1),
                                  fifo["total_buffer_elems"])


def _pre_quant(variant, p, h):
    """A layer's values before quantisation, as the port computes them."""
    if variant == "unfused":
        z = h @ p["w"] + p["b"]
        z = p["gamma"] * (z - p["mu"]) / torch.sqrt(p["sigma2"] + 1e-3) \
            + p["beta"]
    else:
        v = p["gamma"] / torch.sqrt(p["sigma2"] + 1e-3)
        z = h @ (p["w"] * v[None, :]) + (v * (p["b"] - p["mu"]) + p["beta"])
    return torch.relu(z)


def _on_ties(z, s):
    """Where ``round(z / s)`` sits within float rounding of a half step."""
    q = np.asarray(z, np.float64) / float(s)
    return np.abs(np.abs(q - np.floor(q)) - 0.5) < 1e-4


@pytest.mark.parametrize("variant", ["unfused", "fused"])
def test_table3_forwards_equal_the_reference_layer_by_layer(variant):
    """On the same numpy parameters and the same x (196 x 128), each layer
    of the port's forward, fed the port's previous output, equals the
    reference's layer within 1e-5, except at a half-step rounding tie (the
    two matmuls sum in different orders, so a value on a tie may round
    either way; at most 2 such codes); where no tie was met, the whole
    forwards agree within 1e-5."""
    fn_j = getattr(jt3, f"_{variant}_forward")
    fn_t = getattr(tt3, f"_{variant}_forward")
    pn = tt3.params_numpy(0)
    x = np.random.default_rng(1).standard_normal(
        (tt3.ROWS, tt3.DIMS[0])).astype(np.float32)
    tp = tt3.to_torch(pn, "cpu")
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in pn]
    h = x
    n_ties = 0
    for p_j, p_t in zip(jp, tp):
        y_j = np.asarray(fn_j([p_j], jnp.asarray(h)))
        y_t = fn_t([p_t], torch.as_tensor(h)).numpy()
        bad = np.abs(y_j - y_t) > TOL
        if bad.any():
            z = _pre_quant(variant, p_t, torch.as_tensor(h))
            s = torch.max(torch.abs(z)) / 127.0 + 1e-9
            assert _on_ties(z.numpy()[bad], s.item()).all()
            n_ties += int(bad.sum())
        h = y_t
    assert n_ties <= 2
    if n_ties == 0:
        np.testing.assert_allclose(fn_t(tp, torch.as_tensor(x)).numpy(),
                                   np.asarray(fn_j(jp, jnp.asarray(x))),
                                   rtol=0, atol=TOL)


def test_table3_merging_removes_ops_and_runs_on_the_cpu():
    params = tt3.to_torch(tt3.params_numpy(0), "cpu")
    x = torch.zeros((4, tt3.DIMS[0]))
    unfused, unfused_all = tt3.graph_ops(tt3._unfused_forward, params, x)
    fused, fused_all = tt3.graph_ops(tt3._fused_forward, params, x)
    assert 0 < fused < unfused
    assert unfused <= unfused_all and fused <= fused_all
    # per layer on the input's path: mm, +b, -mu, *gamma, /sqrt, +beta,
    # relu and the quantiser's 7 ops; merged, mm, +b, relu and the 7
    layers = len(tt3.DIMS) - 1
    assert (unfused, fused) == (14 * layers, 10 * layers)
    rows = tt3.run(device="cpu")
    assert [r["name"] for r in rows] == [
        "table3/without_opt", "table3/with_fifo_opt",
        "table3/with_relu_bn_merge", "table3/with_all_opt"]
    assert all(r["derived"]["temp_bytes"] is None for r in rows)
    assert rows[0]["derived"]["graph_ops"] == unfused
    assert rows[3]["derived"]["graph_ops"] == fused


# -- Table 6 ----------------------------------------------------------------

def _times(micro_batch):
    return 0.010 + 0.0007 * abs(micro_batch - 8)


def _scripted_probe(cm, x, micro_batch):
    return _times(micro_batch)


@pytest.fixture(scope="module")
def table6_goldens(tmp_path_factory):
    """The port's Table 6 over the four goldens (fast counts, the autotuner
    under a scripted probe), with each golden's reference compile and
    query pool."""
    from repro_torch.deploy import autotune as tat

    entries, refs, pools = {}, {}, {}
    for k, name in enumerate(GOLDENS):
        jm, tm = _pair(name)
        mk, pool = _pool_maker(tm, seed=100 + k)
        entries[name] = (tm, mk, 8)
        refs[name] = jm
        pools[name] = pool
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt6, "autotune_model", lambda cm, **kw: tat.autotune_model(
            cm, probe=_scripted_probe, **kw))
        rows, doc = tt6.run_entries(
            entries, fast=True, tune_dir=str(tmp_path_factory.mktemp("tune")))
    return rows, doc, refs, pools, tmp_path_factory


def test_table6_counts_and_traffic_equal_the_reference(table6_goldens):
    _, doc, refs, _, _ = table6_goldens
    by_model = {r["model"]: r for r in doc["rows"]}
    for name in GOLDENS:
        jm = refs[name]
        r = by_model[name]
        assert r["fused_stages"] == jm.schedule.n_fused
        assert r["fused_conv"] == jm.schedule.n_fused_conv
        if jm.schedule.n_fused_conv:
            ji, _ = _pair(name, conv_lowering="im2col")
            cl = r["conv_lowering"]
            assert cl["fused_traffic_bytes"] == \
                jschedule_cost(jm.schedule.stages).traffic_bytes
            assert cl["im2col_traffic_bytes"] == \
                jschedule_cost(ji.schedule.stages).traffic_bytes
            assert cl["bit_exact"] is True
        else:
            assert "conv_lowering" not in r


def test_table6_parity_equals_the_reference_on_the_same_rows(
        table6_goldens):
    """The compiled-against-unfused argmax parity on the same rows equals
    the reference's."""
    _, doc, refs, pools, _ = table6_goldens
    for r in doc["rows"]:
        jm = refs[r["model"]]
        conv = jm.schedule.n_fused_conv > 0
        n_ref = min(16 if conv else 64, 8 if conv else 64)
        xb = jnp.asarray(pools[r["model"]][:n_ref])
        parity = float((np.argmax(np.asarray(jm.offline(xb)), -1)
                        == np.argmax(np.asarray(jm.reference(xb)), -1)
                        ).mean())
        assert r["argmax_parity"] == parity


def test_table6_tuned_streaming_equals_the_reference(table6_goldens):
    """Under the same scripted probe the tuned micro-batch, the dispatch
    and the modeled cycles are the reference's; every bit-exact field
    reads true."""
    _, doc, refs, _, tmp = table6_goldens
    for s in doc["streaming"]:
        jm = refs[s["model"]]
        n = 8 if jm.schedule.n_fused_conv else 16
        cfg = jat.autotune_model(jm, batch=n, probe=_scripted_probe,
                                 directory=str(tmp.mktemp("j")), force=True)
        tuned = doc["tuned"][s["model"]]
        assert s["micro_batch"] == cfg.micro_batch
        assert s["modeled_cycles"] == cfg.modeled_cycles
        assert tuned["segment_mode"] == cfg.segment_mode
        assert s["bit_exact_vs_offline"] is True
        assert s["server_streaming"]["bit_exact_vs_offline"] is True
        assert s["server_streaming"]["n"] > 0


def test_table6_rows_and_artifact_sections(table6_goldens):
    rows, doc, _, _, _ = table6_goldens
    names = [r["name"] for r in rows]
    for name in GOLDENS:
        for section in ("SingleStream", "Offline", "Streaming",
                        "ServerStreaming"):
            assert f"table6/{name}/{section}" in names
    assert ("table6/ic/Offline/conv_lowering" in names
            and "table6/cnv/Offline/conv_lowering" in names)
    assert set(doc) == {"rows", "streaming", "tuned", "multitenant", "fast"}
    assert doc["fast"] is True and doc["multitenant"]["n"] == 32
    for r in doc["rows"]:
        assert r["offline"]["qps"] > 0 and r["single_stream"]["p50_ms"] > 0


def test_table6_full_width_builders_follow_bench_models():
    """The four models come from ``bench.models`` at the paper's widths, one
    seed each; the conv models keep their graph's input scale."""
    from repro_torch.bench.models import KWS_DIMS, mlp_graph

    assert list(tt6.MODELS) == ["KWS-FINN", "AD-hls4ml", "IC-hls4ml",
                                "IC-FINN-CNV"]
    build, bits, seed = tt6.MODELS["KWS-FINN"]
    assert bits == 3
    assert build(seed).to_json() == mlp_graph(KWS_DIMS, 3, seed,
                                              name="KWS-FINN").to_json()
    cm = tt6._compile_mlp("AD-hls4ml", device="cpu")
    assert cm.schedule.stages[0].in_dim == 128
    assert cm.schedule.in_scale == tt6.IN_SCALE


# -- obs bench --------------------------------------------------------------

def test_obs_guarded_sites_equal_the_reference_on_golden_kws():
    """One ``streaming_compiled`` call records the reference's events (so
    the NullTracer evaluates as many guarded sites), and the bare loop
    gives the instrumented entry point's codes."""
    jm, tm = _pair("kws")
    mk, pool = _pool_maker(tm, seed=7)
    xb = pool[:16]
    jt = JTracer()
    jm.set_tracer(jt)
    jm.streaming_compiled(xb)
    jm.set_tracer(None)
    ref_spans = [(e.name, e.args) for e in jt.events()]
    port_spans = tobs.guarded_spans(tm, xb)
    assert [n for n, _ in port_spans] == [n for n, _ in ref_spans], (
        "span names differ from the reference's")
    for (_, a_t), (_, a_j) in zip(port_spans, ref_spans):
        assert set(a_t) == set(a_j)
    ov_t = tobs._null_overhead(tm, mk, 16, 1)
    ov_j = jobs._null_overhead(jm, mk, 16, 1)
    assert ov_t["n_guarded_sites"] == ov_j["n_guarded_sites"] == len(
        ref_spans)
    assert ov_t["micro_batch"] == ov_j["micro_batch"]
    y_bare = tobs.bare_streaming(tm, xb, tm.default_micro_batch)
    assert torch.equal(y_bare, tm.streaming_compiled(xb)[0])


def test_obs_bare_loop_runs_the_megakernel_plan(monkeypatch):
    """The bare loop replays the port's segment programs: on a planned
    model it launches ``mlp_megakernel`` as ``streaming_compiled`` does."""
    from repro_torch.kernels import ops

    _, tm = _pair("ad")
    assert tm._mega_plans
    calls = []
    real = ops.mlp_megakernel

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ops, "mlp_megakernel", counted)
    xb = _pool_maker(tm, seed=3)[1][:32]
    y = tobs.bare_streaming(tm, xb, 16)
    n_bare = len(calls)
    assert n_bare == len(tm._mega_plans)
    assert torch.equal(y, tm.streaming_compiled(xb, micro_batch=16)[0])
    assert len(calls) == 2 * n_bare


# -- cost-model bench -------------------------------------------------------

def _fixed_table(analytic_factor):
    """The bootstrap fleet (equal in both packages) with an analytic FIFO
    prediction on every row: ``analytic_factor`` times the measured ms,
    alternating above and below it."""
    rows_t, rows_j = tbootstrap_rows(0), jbootstrap_rows(0)
    assert rows_t == rows_j
    out = []
    for i, r in enumerate(rows_t):
        f = analytic_factor if i % 2 else 1.0 / analytic_factor
        out.append({**r, "analytic_ms": r["measured_ms"] * f})
    return out


def test_costmodel_lomo_summary_equals_the_reference_bench():
    rows = _fixed_table(3.0)
    lomo, printed = tcost.lomo_section(rows)
    assert lomo == jlomo(rows, l2=1e-2, seed=0, n_members=8)
    assert printed[-1]["name"] == "costmodel/overall/lomo"
    assert len(printed) == len(lomo)


def test_costmodel_lomo_bar_fails_where_the_reference_bench_would():
    rows = _fixed_table(1.0)            # a perfect analytic model
    ref = jlomo(rows, l2=1e-2, seed=0, n_members=8)["overall"]
    assert ref["median_abs_rel_err"] > ref["analytic_median_abs_rel_err"]
    lomo, _ = tcost.lomo_section(rows)
    assert lomo["overall"] == ref
    (msg,) = tcost.bar_failures({"lomo": lomo, "agreement": {}})
    assert "worse than the analytic" in msg
    lomo_ok, _ = tcost.lomo_section(_fixed_table(3.0))
    assert tcost.bar_failures({"lomo": lomo_ok, "agreement": {}}) == []


@pytest.mark.parametrize("ratios, failing", [
    ({"a": 1.0, "b": 0.9}, []),
    ({"a": 0.8999, "b": 2.0}, ["a"]),
    ({"a": 0.5, "b": 0.1}, ["a", "b"]),
])
def test_costmodel_agreement_bar_holds_every_family(ratios, failing):
    lomo, _ = tcost.lomo_section(_fixed_table(3.0))
    doc = {"lomo": lomo, "agreement": {
        k: {"throughput_ratio": v} for k, v in ratios.items()}}
    msgs = tcost.bar_failures(doc)
    assert [m.split(":")[0] for m in msgs] == failing


def test_costmodel_run_writes_its_numbers_then_asserts(monkeypatch,
                                                       tmp_path):
    """A failed bar raises after the artifact holds every number."""
    import json

    lomo, _ = tcost.lomo_section(_fixed_table(1.0))
    doc = {"lomo": lomo, "agreement": {"a": {"throughput_ratio": 0.5}}}
    monkeypatch.setattr(tcost, "build_entries", lambda device=None: {})
    monkeypatch.setattr(tcost, "run_entries", lambda e: ([], dict(doc)))
    monkeypatch.setenv("REPRO_BENCH_DIR", str(tmp_path))
    with pytest.raises(AssertionError, match="worse than the analytic.*"
                                             "a: predicted config"):
        tcost.run()
    with open(tmp_path / "BENCH_torch_costmodel.json") as f:
        out = json.load(f)
    assert out["agreement"]["a"]["throughput_ratio"] == 0.5
    assert len(out["bar_failures"]) == 2


def test_costmodel_bench_keeps_the_reference_bars():
    from benchmarks import costmodel_bench as jcost

    assert tcost.MIN_AGREEMENT_TPUT == jcost.MIN_AGREEMENT_TPUT == 0.9
    assert tobs.MAX_NULL_OVERHEAD == jobs.MAX_NULL_OVERHEAD == 1.02
    assert tcost.FIT == {"l2": 1e-2, "seed": 0, "n_members": 8}


# -- residency check --------------------------------------------------------

def test_residency_check_passes_on_the_goldens_and_full_width(capsys):
    assert residency.check_graphs(residency.golden_graphs(), "cpu") == 0
    assert residency.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in ("kws", "ad", "KWS-FINN", "AD-hls4ml", "IC-FINN-CNV"):
        assert re.search(rf"^ok +{name} segment 0", out, re.M), name
    assert "0 violation(s)" in out


@pytest.mark.parametrize("field", ["weight_bytes", "tile_bytes",
                                   "cta_bytes"])
def test_residency_check_fails_on_inflated_plans(field, monkeypatch,
                                                 capsys):
    import dataclasses

    real = texecutor.plan_megakernel

    def inflated(*a, **k):
        plan = real(*a, **k)
        if plan is None:
            return None
        return dataclasses.replace(plan, **{field: getattr(plan, field)
                                            + 1})

    monkeypatch.setattr(texecutor, "plan_megakernel", inflated)
    # the three goldens with a dense run: kws, ad and cnv's FC chain
    assert residency.check_graphs(residency.golden_graphs(), "cpu") == 3
    assert residency.main(["--device", "cpu"]) == 1
    assert "FAIL kws segment 0" in capsys.readouterr().out


def test_residency_check_requires_the_mlps_to_plan(monkeypatch, capsys):
    monkeypatch.setattr(texecutor, "plan_megakernel", lambda *a, **k: None)
    assert residency.check_graphs(residency.golden_graphs(), "cpu") == 2
    assert "FAIL ad: its dense chain admitted no megakernel plan" in \
        capsys.readouterr().out


# -- the harness ------------------------------------------------------------

def test_harness_sections_match_the_reference_but_roofline():
    """The reference keeps ``roofline`` out of its ``SECTIONS`` and runs it
    after them; the port's table holds it, last, so the default run is
    the same sections in the same order."""
    from benchmarks import run as jrun

    assert list(trun.SECTIONS) == list(jrun.SECTIONS) + ["roofline"]


def test_harness_reports_every_section_and_fails_on_any(monkeypatch,
                                                        capsys):
    ran = []

    def ok(name):
        return lambda d: ran.append((name, d))

    def boom(d):
        ran.append(("bad", d))
        raise RuntimeError("section failed")

    monkeypatch.setattr(trun, "SECTIONS", {"a": ok("a"), "bad": boom,
                                           "b": ok("b")})
    assert trun.main(["--device", "cpu"]) == 1
    assert ran == [("a", "cpu"), ("bad", "cpu"), ("b", "cpu")]
    out = capsys.readouterr()
    assert "2/3 sections ok" in out.out and "['bad']" in out.out
    assert "RuntimeError: section failed" in out.err
    assert trun.main(["--only", "a,b"]) == 0
    with pytest.raises(SystemExit):
        trun.main(["--only", "roofline"])


def test_harness_runs_the_host_sections_on_the_cpu(capsys):
    assert trun.main(["--only", "table2,table3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "table2/KWS-FINN" in out and "table3/with_all_opt" in out
