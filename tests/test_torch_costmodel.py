"""The port's learned wave-cost model (``repro_torch.costmodel``) and the
autotuner's model mode against the reference's.

The predictor, its artifact, its fit, the bootstrap fleet and
``build_dataset`` are copies and must give the reference's numbers and
bytes.
``wave_features`` reads the port's planners: on staged schedules it gives
the reference's vectors; where a megakernel run is planned, exactly
``log_residency_bytes`` differs (the port prices the run's row tiles at
its per-CTA row tile, the reference at 128 rows), and a tuned conv
stage's ``log_band_bytes`` follows whichever row block the stage holds.
Model mode makes no probe, reads no clock, runs no model, and picks the
reference's micro-batch wherever the features agree.
"""

import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.core.qir import Graph as JGraph
from repro.core.qir import export_qcnn, export_qmlp
from repro.costmodel import dataset as jdata
from repro.costmodel import features as jfeat
from repro.costmodel import model as jmodel
from repro.deploy import autotune as jat
from repro.deploy import compile_graph as jcompile
from repro.models.tiny import ADAutoencoder, CNVModel, ICModel, KWSMLP
from repro_torch import costmodel as tcm
from repro_torch.core.qir import Graph as TGraph
from repro_torch.costmodel import dataset as tdata
from repro_torch.costmodel import features as tfeat
from repro_torch.costmodel import model as tmodel
from repro_torch.deploy import FusedConvThresholdStage
from repro_torch.deploy import autotune as tat
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.models import tiny as ttiny
from repro_torch.obs import Tracer, export_prediction_records
from repro_torch.obs import timer as ttimer
from _torch_threads import one_torch_thread  # noqa: F401

MBS = (1, 2, 4, 8, 16, 32, 64)
#: the features the port's planners set differently from the reference's
#: on a schedule with a planned megakernel run
DIFFER_WHERE_PLANNED = {"log_residency_bytes"}


def _np(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _graph(kind):
    if kind in ("kws", "ad"):
        model = (KWSMLP(width=32) if kind == "kws"
                 else ADAutoencoder(width=24))
        params = model.init(jax.random.PRNGKey(0 if kind == "kws" else 1))
        hidden, _ = model.layers()
        return export_qmlp(hidden, params["hidden"], params["head"],
                           meta={"model": kind.upper()}, freeze_scales=True,
                           in_scale=1.0 / 127.0)
    if kind == "ic":
        model = ICModel(in_hw=8, filters=(4, 4), kernels=(3, 3),
                        strides=(1, 2))
        cal = np.random.default_rng(0).integers(-127, 128, (4, 8, 8, 3))
        return export_qcnn(model, _np(model.init(jax.random.PRNGKey(2))),
                           calibrate=cal)
    model = CNVModel(channels=(4, 4, 8, 8, 8, 8), fc=(16, 16))
    return export_qcnn(model, _np(model.init(jax.random.PRNGKey(3))))


KINDS = ("kws", "ad", "ic", "cnv")
_GRAPHS = {}


def _pair(kind, megakernel=None):
    """(reference, port) compiled models of the same QIR JSON on the CPU."""
    if kind not in _GRAPHS:
        _GRAPHS[kind] = _graph(kind).to_json()
    text = _GRAPHS[kind]
    jg = JGraph.from_json(text)
    scale = jg.meta.get("in_scale", 1.0 / 127.0)
    jm = jcompile(jg, in_scale=scale, use_pallas=False,
                  megakernel=megakernel)
    tm = tcompile(TGraph.from_json(text), in_scale=scale, device="cpu",
                  megakernel=megakernel)
    return jm, tm


# ---------------------------------------------------------------------------
# schema, artifact, predictor
# ---------------------------------------------------------------------------

def test_schema_and_knobs_are_the_references():
    assert tfeat.FEATURE_NAMES == jfeat.FEATURE_NAMES
    assert tfeat.FEATURE_SCHEMA_VERSION == jfeat.FEATURE_SCHEMA_VERSION
    assert tdata.DATASET_SCHEMA_VERSION == jdata.DATASET_SCHEMA_VERSION
    assert tmodel.ARTIFACT_ENV == jmodel.ARTIFACT_ENV == \
        "REPRO_COSTMODEL_ARTIFACT"
    assert sorted(tcm.__all__) == sorted(
        __import__("repro.costmodel", fromlist=["__all__"]).__all__)


def test_shipped_artifact_is_the_references_bytes(monkeypatch):
    monkeypatch.delenv("REPRO_COSTMODEL_ARTIFACT", raising=False)
    tpath, jpath = tmodel.default_artifact_path(), \
        jmodel.default_artifact_path()
    assert tpath.endswith(os.path.join("repro_torch", "costmodel",
                                       "artifacts", "default.json"))
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    pred = tmodel.load_default()
    assert pred.meta["trained_on"] == "bootstrap_rows"
    assert pred.to_dict() == jmodel.load_default().to_dict()


def _vectors():
    rows = jmodel.bootstrap_rows()
    x = np.array([[r["features"][k] for k in jfeat.FEATURE_NAMES]
                  for r in rows])
    rng = np.random.default_rng(11)
    noise = x + rng.normal(0.0, 0.5, x.shape)
    return np.concatenate([x, noise])


def test_predict_ms_equals_reference_on_the_same_vectors():
    tp, jp = tmodel.load_default(), jmodel.load_default()
    X = _vectors()
    np.testing.assert_array_equal(tp.predict_ms(X), jp.predict_ms(X))
    for row in X[::37]:
        assert tp.predict_ms(row) == jp.predict_ms(row)
        d = dict(zip(tfeat.FEATURE_NAMES, row))
        assert tp.predict_ms(d) == jp.predict_ms(d)
        assert isinstance(tp.predict_ms(d), float)


@pytest.mark.parametrize("kw", [dict(l2=1e-2, seed=0, n_members=8),
                                dict(l2=0.5, seed=3, n_members=3,
                                     subsample=0.5),
                                dict(l2=1e-3, seed=1, n_members=1)])
def test_fit_gives_the_references_weights(kw):
    rows = tmodel.bootstrap_rows()
    assert rows == jmodel.bootstrap_rows()
    t = tmodel.WaveCostPredictor.fit_rows(rows, meta={"n": 1}, **kw)
    j = jmodel.WaveCostPredictor.fit_rows(rows, meta={"n": 1}, **kw)
    assert t.to_dict() == j.to_dict()


def test_default_artifact_retrains_to_the_references_bytes(tmp_path):
    tp = tmodel.make_default_artifact(str(tmp_path / "t" / "d.json"))
    jp = jmodel.make_default_artifact(str(tmp_path / "j" / "d.json"))
    assert open(tp, "rb").read() == open(jp, "rb").read()


def test_artifact_round_trip_env_override_and_schema_guard(tmp_path,
                                                           monkeypatch):
    rows = tmodel.bootstrap_rows()[::5]
    pred = tmodel.WaveCostPredictor.fit_rows(rows, n_members=2, seed=4)
    path = pred.save(str(tmp_path / "p.json"))
    monkeypatch.setenv("REPRO_COSTMODEL_ARTIFACT", path)
    assert tmodel.default_artifact_path() == path
    assert tmodel.load_default().to_dict() == pred.to_dict()
    assert jmodel.load_default().to_dict() == pred.to_dict()
    bad = dict(pred.to_dict(), schema_version=99)
    with pytest.raises(ValueError, match="schema"):
        tmodel.WaveCostPredictor.from_dict(bad)
    bad = dict(pred.to_dict(), feature_names=list(reversed(
        pred.feature_names)))
    with pytest.raises(ValueError, match="feature names"):
        tmodel.WaveCostPredictor.from_dict(bad)
    with pytest.raises(ValueError, match="bad training shapes"):
        tmodel.WaveCostPredictor.fit(np.zeros((0, 14)), np.zeros(0))


def test_leave_one_model_out_equals_reference():
    rows = tmodel.bootstrap_rows()[::3]
    kw = dict(n_members=2, seed=1)
    assert tmodel.leave_one_model_out(rows, **kw) == \
        jmodel.leave_one_model_out(rows, **kw)


@pytest.mark.parametrize("name", ["ic", "cnv"])
@pytest.mark.parametrize("mb", [1, 16])
def test_features_from_model_cost_equal_reference(name, mb):
    """The uncompiled search-space features of the port's model
    descriptions equal the reference's."""
    t = ttiny.ICModel() if name == "ic" else ttiny.CNVModel()
    j = ICModel() if name == "ic" else CNVModel()
    kw = dict(n_segments=2, n_conv_stages=len(t.conv_layers()),
              megakernel=name == "cnv")
    assert tfeat.features_from_model_cost(t.cost(), mb, **kw) == \
        jfeat.features_from_model_cost(j.cost(), mb, **kw)
    v = tfeat.feature_vector(tfeat.features_from_model_cost(t.cost(), mb))
    assert v.shape == (len(tfeat.FEATURE_NAMES),)
    with pytest.raises(KeyError):
        tfeat.feature_vector({"log_wave_cycles": 1.0})


# ---------------------------------------------------------------------------
# wave features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mb", MBS)
def test_wave_features_equal_reference_on_staged_schedules(kind, mb):
    """Staged dispatch (``megakernel=False``) and the staged features of
    the default model: the reference's vectors, feature for feature."""
    jm, tm = _pair(kind, megakernel=False)
    assert tfeat.wave_features(tm, mb) == jfeat.wave_features(jm, mb)
    jm, tm = _pair(kind)
    assert tfeat.wave_features(tm, mb, "staged") == \
        jfeat.wave_features(jm, mb, "staged")
    assert tfeat.wave_features(tm, mb, "staged")["megakernel"] == 0.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mb", [1, 8, 64])
def test_wave_features_differ_only_where_the_planners_differ(kind, mb):
    """With a planned megakernel run (KWS, AD, CNV's FCs) exactly
    ``DIFFER_WHERE_PLANNED`` differs, and the port's residency is the
    run's bytes at the port's row tile; IC plans no run and equals the
    reference in every mode."""
    from repro_torch.core.bops import megakernel_residency_bytes
    from repro_torch.deploy import plan_megakernel

    jm, tm = _pair(kind)
    for mode in (None, "megakernel"):
        t = tfeat.wave_features(tm, mb, mode)
        j = jfeat.wave_features(jm, mb, mode)
        differ = {k for k in t if t[k] != j[k]}
        plans = [p for p in (plan_megakernel(tm.schedule.stages, seg)
                             for seg in tm.segments) if p is not None]
        if kind == "ic":
            assert not plans and not differ
            continue
        assert plans and differ == DIFFER_WHERE_PLANNED
        assert t["megakernel"] == j["megakernel"] == 1.0
        res = sum(megakernel_residency_bytes(
            tm.schedule.stages[p.start:p.stop],
            block_m=p.block_m)["total_bytes"] for p in plans)
        assert t["log_residency_bytes"] == math.log1p(res)
        assert all(p.block_m < 128 for p in plans)


@pytest.mark.parametrize("kind", KINDS)
def test_full_width_features_differ_only_in_residency(kind):
    """The four Table-1 models at the paper's widths
    (``repro_torch.bench.models``): both planners admit the same runs, so
    the default mode's features differ in ``DIFFER_WHERE_PLANNED`` exactly
    where a run is planned (all but IC) and nowhere else."""
    from repro_torch.bench import models as bm

    g = {"kws": lambda: bm.mlp_graph(bm.KWS_DIMS, bm.KWS_BITS, 1,
                                     name="kws"),
         "ad": lambda: bm.mlp_graph(bm.AD_DIMS, bm.AD_BITS, 2, name="ad"),
         "ic": lambda: bm.ic_graph(3), "cnv": lambda: bm.cnv_graph(4)}[kind]()
    text = g.to_json()
    scale = g.meta.get("in_scale", 1.0 / 127.0)
    jm = jcompile(JGraph.from_json(text), in_scale=scale, use_pallas=False)
    tm = tcompile(TGraph.from_json(text), in_scale=scale, device="cpu")
    for mb in (1, 16):
        t, j = tfeat.wave_features(tm, mb), jfeat.wave_features(jm, mb)
        differ = {k for k in t if t[k] != j[k]}
        assert differ == (set() if kind == "ic" else DIFFER_WHERE_PLANNED)
        assert t["megakernel"] == j["megakernel"] == float(kind != "ic")


@pytest.mark.parametrize("kind", ["ic", "cnv"])
def test_band_bytes_follow_the_row_block_the_stage_holds(kind):
    """A tuned conv stage's ``log_band_bytes`` (and the traffic terms that
    charge its band) read its own ``block_h``: with the same row blocks
    set on both schedules the features agree again, so a difference there
    is the two tuners' row-block picks."""
    jm, tm = _pair(kind, megakernel=False)
    blocks = {s.name: max(1, s.geom.out_h // 2)
              for s in tm.schedule.stages
              if isinstance(s, FusedConvThresholdStage)}
    assert blocks
    before = tfeat.wave_features(tm, 8)
    for s in tm.schedule.stages:
        if s.name in blocks:
            s.block_h = blocks[s.name]
    for s in jm.schedule.stages:
        if s.name in blocks:
            s.block_h = blocks[s.name]
    after = tfeat.wave_features(tm, 8)
    assert after == jfeat.wave_features(jm, 8)
    # a tuned direct stage's traffic is its band bytes too
    assert {k for k in after if after[k] != before[k]} <= {
        "log_band_bytes", "log_traffic_bytes", "log_wave_traffic_bytes"}
    assert after["log_band_bytes"] != before["log_band_bytes"]


# ---------------------------------------------------------------------------
# the training table (``build_dataset``)
# ---------------------------------------------------------------------------

def _records():
    tr = Tracer()
    rng = np.random.default_rng(2)
    for i in range(12):
        t = 0.01 * i
        tr.add_span("wave", t, t + float(rng.uniform(1e-4, 3e-3)), args={
            "model": ("KWS", "AD", "ghost")[i % 3], "platform": "cpu",
            "micro_batch": (4, 8, 0)[i % 3] if i != 5 else 16,
            "n_valid": 3, "predicted_ms": 0.5 + 0.1 * i})
    return tr


def _config(kind):
    return {"key": f"{kind.upper()}-cpu-0123456789", "platform": "cpu",
            "segment_mode": "megakernel",
            "candidates": [{"micro_batch": 4, "n_micro": 4, "probe_ms": 2.0},
                           {"micro_batch": 8, "n_micro": 2, "probe_ms": 1.5},
                           {"micro_batch": 16, "n_micro": 1}],
            "segment_mode_model": {"n_micro": 2, "wave_rows": 8,
                                   "probe_ms": {"megakernel": 1.2,
                                                "staged": 1.6}},
            "block_mn_probe": {"n_micro": 2, "wave_rows": 8,
                               "probe_ms": {"tuned": 1.1,
                                            "default": 1.3}}}


def _cost_resolver(feat):
    """A resolver from raw cost numbers (``features_from_costs`` of either
    package): the same features on both sides by construction."""
    def resolve(model, platform, micro_batch, segment_mode):
        if model not in ("KWS", "AD"):
            return None
        return feat.features_from_costs(
            wave_cycles=100.0 * micro_batch + len(model), micro_batch=
            micro_batch, bops=1e6, traffic_bytes=1e3 * len(model),
            param_bytes=5e4, n_stages=3 + len(model), n_dense_stages=3,
            megakernel=segment_mode == "megakernel")
    return resolve


def _harvest(data, resolver, recs):
    cfgs = [_config("kws"), _config("ad"), _config("ghost")]
    docs = [{"provenance": {"backend": "cpu"}, "models": {
        "KWS": {"wave_service_ms": 0.7, "micro_batch": 8,
                "segment_mode": "staged"},
        "AD": {"wave_service_ms": 0.0, "micro_batch": 8}, "x": 3}},
        {"rows": []}]
    return data.build_dataset(resolver, trace_records=recs,
                              tuned_configs=cfgs, bench_docs=docs)


def test_build_dataset_rows_equal_the_references(tmp_path):
    """Trace records (through the port's JSONL shard), tuned-config audit
    trails and bench documents: the same rows and the same bytes on the
    same features; with each package's compiled resolver the rows differ
    only in ``DIFFER_WHERE_PLANNED`` and only on megakernel rows."""
    shard = export_prediction_records(_records(), str(tmp_path / "r.jsonl"))
    recs = tdata.load_trace_records(shard)
    assert recs == jdata.load_trace_records(shard)
    t = _harvest(tdata, _cost_resolver(tfeat), recs)
    j = _harvest(jdata, _cost_resolver(jfeat), recs)
    assert len(t.rows) > 10
    assert {r["source"] for r in t.rows} == {"trace", "autotune", "bench"}
    assert t.to_json_str() == j.to_json_str()
    np.testing.assert_array_equal(t.X(), j.X())
    np.testing.assert_array_equal(t.y_ms(), j.y_ms())
    assert t.models() == j.models() == ["AD", "KWS"]
    path = t.save(str(tmp_path / "ds.json"))
    assert tdata.Dataset.load(path).to_json_str() == t.to_json_str()
    shuffled = tdata.Dataset(rows=list(reversed(t.rows)))
    assert shuffled.to_json_str() == t.to_json_str()

    models = {k.upper(): _pair(k) for k in ("kws", "ad")}
    t = _harvest(tdata, tdata.compiled_feature_resolver(
        {k: v[1] for k, v in models.items()}), recs)
    j = _harvest(jdata, jdata.compiled_feature_resolver(
        {k: v[0] for k, v in models.items()}), recs)
    assert len(t.rows) == len(j.rows)
    for a, b in zip(t.rows, j.rows):
        assert {k: v for k, v in a.items() if k != "features"} == \
            {k: v for k, v in b.items() if k != "features"}
        differ = {k for k in a["features"]
                  if a["features"][k] != b["features"][k]}
        mega = a["features"]["megakernel"] == 1.0
        assert differ == (DIFFER_WHERE_PLANNED if mega else set())


def test_probe_audit_trail_becomes_rows(tmp_path):
    """A probe-mode config of the port (scripted probe) harvests to the
    rows the reference harvests from the same dict: the port's keys carry
    its platform ("torch-cpu"), and the model name is read past it."""
    jm, tm = _pair("kws")
    cfg = tat.autotune_model(
        tm, batch=16, probe=lambda cm, x, mb: 0.001 * (1 + abs(mb - 4)),
        directory=str(tmp_path), force=True)
    assert cfg.key.startswith("KWS-torch-cpu-")
    assert tdata._config_model_name(cfg.to_dict()) == "KWS"
    assert tdata._config_model_name({"key": "KWS-cpu-0a1b2c3d4e",
                                     "platform": "cpu"}) == "KWS"
    rows = tdata.rows_from_tuned_config(
        cfg, tdata.compiled_feature_resolver({"KWS": tm}))
    d = dict(cfg.to_dict(), key="KWS-cpu-0a1b2c3d4e", platform="cpu")
    want = jdata.rows_from_tuned_config(
        d, jdata.compiled_feature_resolver({"KWS": jm}))
    assert len(rows) == len(want) == len(cfg.probe_ms) + 2 + 2
    for r, w in zip(rows, want):
        assert {k: v for k, v in r.items() if k not in ("features",
                                                        "platform")} == \
            {k: v for k, v in w.items() if k not in ("features",
                                                     "platform")}
        assert r["platform"] == "torch-cpu"
        assert set(r["features"]) == set(tfeat.FEATURE_NAMES)


# ---------------------------------------------------------------------------
# the autotuner's model mode
# ---------------------------------------------------------------------------

class _NoClock:
    def now(self):
        raise AssertionError("model mode read the clock")

    def sleep(self, seconds):
        raise AssertionError("model mode slept")


def _refuse(*a, **k):
    raise AssertionError("model mode ran the model")


@pytest.mark.parametrize("kind", KINDS)
def test_model_mode_makes_no_probe_and_records_predicted(kind, tmp_path,
                                                         monkeypatch):
    """A probe that raises is never called; no clock is read; neither the
    streaming path nor ``stage_latencies`` runs; every candidate carries
    its predicted wave and pool ms; ``source`` is "predicted"."""
    _, tm = _pair(kind)
    monkeypatch.setattr(tm, "streaming_compiled", _refuse)
    monkeypatch.setattr(tm, "stage_latencies", _refuse)
    monkeypatch.setattr(tm, "offline", _refuse)

    def probe(cm, x, mb):
        raise AssertionError("model mode called the probe")

    with ttimer.fake(_NoClock()):
        cfg = tat.autotune_model(tm, batch=32, probe=probe, mode="model",
                                 directory=str(tmp_path), force=True)
    assert cfg.source == "predicted"
    assert cfg.probe_ms is None and cfg.seed_stage_ms is None
    assert cfg.block_mn_probe == {}
    assert all("probe_ms" not in c for c in cfg.candidates)
    assert all(c["predicted_total_ms"] == c["predicted_wave_ms"]
               * c["n_micro"] for c in cfg.candidates)
    best = min(cfg.candidates, key=lambda c: (c["predicted_total_ms"],
                                              c["micro_batch"]))
    assert cfg.micro_batch == best["micro_batch"]
    if cfg.segment_mode_model:
        pm = cfg.segment_mode_model["predicted_ms"]
        assert "probe_ms" not in cfg.segment_mode_model
        assert cfg.segment_mode == ("megakernel" if pm["megakernel"]
                                    < pm["staged"] else "staged")
    assert tm.megakernel is None                 # the search left it alone
    assert tat.load_config(cfg.key, str(tmp_path)) == cfg


@pytest.mark.parametrize("kind", KINDS)
def test_model_mode_picks_the_references_micro_batch(kind, tmp_path):
    """Where the features agree (staged schedules) every candidate's
    predictions and the micro-batch equal the reference's model mode; so
    do the staged half of the dispatch scores, the block models aside."""
    jm, tm = _pair(kind, megakernel=False)
    j = jat.autotune_model(jm, batch=32, mode="model", force=True,
                           directory=str(tmp_path / "j"))
    t = tat.autotune_model(tm, batch=32, mode="model", force=True,
                           directory=str(tmp_path / "t"))
    assert t.micro_batch == j.micro_batch
    assert t.source == j.source == "predicted"
    strip = lambda cs: [{k: v for k, v in c.items()  # noqa: E731
                         if k != "probe_ms"} for c in cs]
    assert strip(t.candidates) == strip(j.candidates)
    assert t.fifo_depths == j.fifo_depths
    assert t.modeled_cycles == j.modeled_cycles
    assert bool(t.segment_mode_model) == bool(j.segment_mode_model)
    if t.segment_mode_model:
        assert t.segment_mode_model["predicted_ms"]["staged"] == \
            j.segment_mode_model["predicted_ms"]["staged"]
        assert t.segment_mode_model["model_pick"] == \
            j.segment_mode_model["model_pick"]
    if kind == "ic":
        assert t.segment_mode == j.segment_mode == "staged"


@pytest.mark.parametrize("kind", ["kws", "ic"])
def test_compile_graph_under_repro_autotune_model(kind, tmp_path,
                                                  monkeypatch):
    """``compile_graph(..., autotune=True)`` with ``REPRO_AUTOTUNE=model``
    applies a predicted config; the tuned codes and logits equal the
    untuned ones."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "model")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    text = _GRAPHS.get(kind) or _graph(kind).to_json()
    g = TGraph.from_json(text)
    scale = g.meta.get("in_scale", 1.0 / 127.0)
    cm = tcompile(g, in_scale=scale, device="cpu", autotune=True)
    plain = tcompile(g, in_scale=scale, device="cpu")
    assert cm.tuned is not None and cm.tuned.source == "predicted"
    assert cm.default_micro_batch == cm.tuned.micro_batch
    s0 = cm.schedule.stages[0]
    shape = ((6, s0.geom.in_h, s0.geom.in_w, s0.geom.in_ch)
             if hasattr(s0, "geom") else (6, s0.in_dim))
    x = np.random.default_rng(5).integers(-127, 128, shape).astype(np.int32)
    for a, b in zip(cm.stage_outputs(x)[:-1], plain.stage_outputs(x)[:-1]):
        assert torch.equal(a, b)
    torch.testing.assert_close(cm.offline(x), plain.offline(x), rtol=1e-5,
                               atol=1e-5)
    y, _ = cm.streaming_compiled(x)
    torch.testing.assert_close(y, plain.offline(x), rtol=1e-5, atol=1e-5)
    files = os.listdir(tmp_path)
    assert len(files) == 1
    assert json.load(open(tmp_path / files[0]))["source"] == "predicted"
