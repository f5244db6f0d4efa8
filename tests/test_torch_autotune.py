"""The port's autotuner (``repro_torch.deploy.autotune``, probe mode)
against the reference's on the same schedules and scripted probes.

Both packages compile the same QIR JSON (the reference's exporters on a
JAX-initialised KWS MLP and IC CNN). Under one scripted probe the
FIFO-ranked micro-batch, the audit trail of the ranking and the probed
megakernel-or-staged choice equal the reference's; the block models
differ on purpose (the port prices its CUDA kernels, the reference a
TPU), and so does the cache key (the port keys on itself and its device,
so neither package reads the other's configs). Applying a config never
changes an integer.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.core.qir import export_qcnn, export_qmlp
from repro.deploy import autotune as jat
from repro.deploy import compile_graph as jcompile
from repro.models.tiny import ICModel, KWSMLP
from repro_torch.core.qir import Graph as TGraph
from repro_torch.deploy import FusedConvThresholdStage, FusedThresholdStage
from repro_torch.deploy import autotune as tat
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.kernels import ops as tops

IN_SCALE = 1.0 / 127.0
MBS = (1, 2, 4, 8, 16, 32, 64)


def _mlp_graph():
    model = KWSMLP(width=16)
    params = model.init(jax.random.PRNGKey(0))
    hidden_defs, _ = model.layers()
    return export_qmlp(hidden_defs, params["hidden"], params["head"],
                       meta={"model": "KWS"}, freeze_scales=True,
                       in_scale=IN_SCALE)


def _conv_graph():
    rng = np.random.default_rng(5)
    model = ICModel(in_hw=8, filters=(4, 4), kernels=(3, 3), strides=(1, 2))
    params = model.init(jax.random.PRNGKey(5))
    cal = rng.integers(-127, 128, (4, 8, 8, 3)).astype(np.int32)
    return export_qcnn(model, params, calibrate=cal)


GRAPHS = {"mlp": _mlp_graph, "conv": _conv_graph}


def _pair(kind):
    jg = GRAPHS[kind]()
    scale = jg.meta.get("in_scale", IN_SCALE)
    jm = jcompile(jg, in_scale=scale, use_pallas=False)
    tm = tcompile(TGraph.from_json(jg.to_json()), in_scale=scale,
                  device="cpu")
    return jm, tm


def _probe(times, mega_penalty=0.0):
    """Scripted seconds per micro-batch; ``mega_penalty`` is added when the
    model dispatches megakernels explicitly (``megakernel=True``)."""
    def probe(cm, x, micro_batch):
        return times[micro_batch] + (mega_penalty if cm.megakernel is True
                                     else 0.0)
    return probe


@pytest.mark.parametrize("raw", ["off", "0", "", "false", "no", "none",
                                 "disable", "disabled", "OFF", " Off ",
                                 "probe", "1", "on", "true", "yes", "probed",
                                 "measure", "model", "predict", "predicted",
                                 "predictor", "MODEL", None, "modle", "2",
                                 "maybe", "MODEL X"])
def test_tri_state_parsing_equals_reference(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    else:
        monkeypatch.setenv("REPRO_AUTOTUNE", raw)
    outcomes = []
    for mod in (jat, tat):
        try:
            outcomes.append((mod.autotune_mode(), mod.autotune_enabled()))
        except ValueError as e:
            assert "REPRO_AUTOTUNE" in str(e)
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("kind", ["mlp", "conv"])
@pytest.mark.parametrize("penalty", [0.0, 0.001, -0.001])
def test_search_equals_reference_under_one_scripted_probe(kind, penalty,
                                                          tmp_path):
    """Micro-batch ranking, probes, winner and segment dispatch as the
    reference's; a negative penalty makes the megakernel probe faster,
    a positive one slower, zero ties (the traffic model decides)."""
    jm, tm = _pair(kind)
    times = {mb: 0.010 + 0.0007 * abs(mb - 8) for mb in MBS}
    j = jat.autotune_model(jm, batch=32, probe=_probe(times, penalty),
                           directory=str(tmp_path / "j"), force=True)
    t = tat.autotune_model(tm, batch=32, probe=_probe(times, penalty),
                           directory=str(tmp_path / "t"), force=True)
    assert t.micro_batch == j.micro_batch
    assert t.candidates == j.candidates
    assert t.probe_ms == j.probe_ms
    assert t.fifo_depths == j.fifo_depths
    assert t.modeled_cycles == j.modeled_cycles
    assert t.segment_mode == j.segment_mode
    assert t.segment_mode_model == j.segment_mode_model
    assert t.block_mn_probe.get("pick") == j.block_mn_probe.get("pick")
    assert set(t.block_mn) <= {s.name for s in tm.schedule.stages}
    assert set(t.block_h) == set(j.block_h)
    if kind == "mlp":
        want = {0.0: "megakernel", 0.001: "staged", -0.001: "megakernel"}
        assert t.segment_mode == want[penalty]
    else:
        assert t.segment_mode == "staged" and t.segment_mode_model == {}
    assert tm.megakernel is None         # probing restored the mode


def test_search_is_deterministic_and_the_cache_round_trips(tmp_path):
    _, tm = _pair("conv")
    probe = _probe({mb: 0.010 + 0.001 * mb for mb in MBS})
    a = tat.autotune_model(tm, batch=32, probe=probe,
                           directory=str(tmp_path), force=True)
    b = tat.autotune_model(tm, batch=32, probe=probe,
                           directory=str(tmp_path / "other"), force=True)
    assert a == b
    assert a.probe_ms[str(a.micro_batch)] == min(a.probe_ms.values())
    loaded = tat.load_config(a.key, str(tmp_path))
    assert loaded == a
    path = tat.config_path(a.key, str(tmp_path))
    with open(path) as f:
        first = f.read()
    tat.save_config(loaded, str(tmp_path))
    with open(path) as f:
        assert f.read() == first

    def no_probe(cm, x, mb):
        raise AssertionError("probed although the cache holds the config")

    assert tat.autotune_model(tm, batch=32, probe=no_probe,
                              directory=str(tmp_path)) == a


def test_stale_config_version_re_searches(tmp_path):
    cfg = tat.TunedConfig(key="stale", platform="torch-cpu", micro_batch=8,
                          block_h={}, fifo_depths=[2, 2], modeled_cycles=1,
                          modeled_traffic_bytes=1.0)
    cfg.version = tat.CONFIG_VERSION - 1
    tat.save_config(cfg, str(tmp_path))
    assert tat.load_config("stale", str(tmp_path)) is None
    d = tat.TunedConfig(key="k", platform="torch-cpu", micro_batch=8,
                        block_h={"c": 4}, fifo_depths=[1],
                        modeled_cycles=3, modeled_traffic_bytes=2.5,
                        block_mn={"d": [32, 128]}).to_dict()
    d["future_field"] = 1
    assert tat.TunedConfig.from_dict(d).block_mn == {"d": [32, 128]}


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_apply_tuned_changes_no_integer(kind, tmp_path):
    _, tm = _pair(kind)
    rng = np.random.default_rng(6)
    s0 = tm.schedule.stages[0]
    shape = ((6, s0.geom.in_h, s0.geom.in_w, s0.geom.in_ch)
             if isinstance(s0, FusedConvThresholdStage) else (6, s0.in_dim))
    x = torch.as_tensor(rng.integers(-127, 128, shape), dtype=torch.int32)
    outs = [o.clone() for o in tm.stage_outputs(x)]
    y_before = tm.offline(x)
    assert tm.default_micro_batch == 16
    cfg = tat.autotune_model(tm, batch=16, probe=_probe({m: 0.005
                                                         for m in MBS}),
                             directory=str(tmp_path), force=True)
    tm.apply_tuned(cfg)
    assert tm.tuned is cfg and tm.default_micro_batch == cfg.micro_batch
    for s in tm.schedule.stages:
        if isinstance(s, FusedConvThresholdStage):
            assert s.block_h == cfg.block_h[s.name]
            assert 1 <= s.block_h <= s.geom.out_h
        elif isinstance(s, FusedThresholdStage) and cfg.block_mn:
            assert [s.block_m, s.block_n] == cfg.block_mn[s.name]
            assert s.block_m in tops.TMM_TILE_SIZES
    for a, b in zip(tm.stage_outputs(x), outs):
        assert torch.equal(a, b)
    torch.testing.assert_close(tm.offline(x), y_before, rtol=0, atol=0)
    y_s, st = tm.streaming_compiled(x)
    assert st.micro_batch == cfg.micro_batch
    torch.testing.assert_close(y_s, y_before, rtol=1e-6, atol=1e-6)


def test_schedule_key_differs_from_reference_and_is_stable():
    jm, tm = _pair("mlp")
    kt, kj = tat.schedule_key(tm), jat.schedule_key(jm)
    assert kt != kj
    assert "-torch-cpu-" in kt and "-cpu-" in kj
    assert kt == tat.schedule_key(_pair("mlp")[1])
    assert kt != tat.schedule_key(_pair("conv")[1])
    assert tat.platform_key("cpu") == "torch-cpu"


def test_plan_block_h_prices_the_cuda_kernel():
    from repro_torch.deploy import ConvGeom

    g = ConvGeom(kernel=3, stride=1, padding="SAME", in_h=32, in_w=32,
                 in_ch=16, out_h=32, out_w=32, out_ch=32)
    plan = tat.plan_block_h(g)
    assert [r["block_h"] for r in plan["candidates"]] == \
        jat.block_h_candidates(32)
    for r in plan["candidates"]:
        # the kernel's own layout: 8-warp blocks, 128 pixels a pass, shared
        # memory from the host plan, residency from threads and shared
        # memory, the same band bytes as the reference's model
        kp = tops.conv_threshold_plan(16, 32, 3, 1, 34, 32, 32, r["block_h"],
                                      255, samples=64)
        assert r["smem_bytes"] == kp["smem_bytes"]
        assert kp["samples_per_block"] == 1           # 32 x 32 outputs
        assert r["pixels"] == kp["block_h"] * 32
        assert r["passes"] == -(-r["pixels"] // tops.conv_pass_pixels(
            kp["block_n"])) == -(-r["pixels"] // 128)
        assert r["blocks_per_sm"] == tat.blocks_per_sm(tat.K2_THREADS,
                                                       r["smem_bytes"])
        assert r["blocks"] == 64 * -(-32 // kp["block_h"])
        assert r["waves"] == -(-r["blocks"] // (tat.H100_SMS
                                                * r["blocks_per_sm"]))
        assert r["slot_passes"] == r["waves"] * r["passes"]
        assert r["input_bytes"] == tat.conv_input_band_bytes(g, r["block_h"])
    assert plan["slot_passes"] == min(r["slot_passes"]
                                      for r in plan["candidates"])
    # few samples: every block fits in one wave, so the blocks of one full
    # pass (4 rows x 32 pixels) tie with smaller ones on passes and win on
    # input bytes (fewer halo rows)
    assert tat.plan_block_h(g, samples=2)["block_h"] == 4
    # many samples: several waves; taller blocks hold more shared memory
    # (fewer resident) and more passes, so the pick stays small
    many = tat.plan_block_h(g, samples=1024)
    assert many["block_h"] == 4
    assert max(r["waves"] for r in many["candidates"]) > 1
    # a shallow bank leaves room: more blocks of one size are resident
    rows1 = {r["block_h"]: r for r in tat.plan_block_h(
        g, samples=1024, n_steps=1)["candidates"]}
    rows255 = {r["block_h"]: r for r in many["candidates"]}
    assert all(rows1[b]["blocks_per_sm"] >= rows255[b]["blocks_per_sm"]
               for b in rows1)


def test_plan_block_mn_picks_among_the_kernels_tiles():
    plan = tat.plan_block_mn(490, 256, n_steps=7, wave_rows=64)
    assert (plan["block_m"], plan["block_n"]) == (32, 32)
    assert {(r["block_m"], r["block_n"]) for r in plan["candidates"]} == \
        {(a, b) for a in tops.TMM_TILE_SIZES for b in tops.TMM_TILE_SIZES}
    assert all(r["fits_smem"] and r["smem_bytes"] <= 232_448
               for r in plan["candidates"])
    assert plan["slot_mma"] == min(r["slot_mma"] for r in plan["candidates"])
    for r in plan["candidates"]:
        wm, wn = tat.k1_warps(r["block_m"], r["block_n"])
        assert r["threads"] == 32 * wm * wn <= 512
        assert r["smem_bytes"] == tops.threshold_matmul_plan(
            r["block_m"], r["block_n"], 7)["smem_bytes"]
        # 490 deep: 8 k tiles of two 32-deep steps over the warp's tiles
        assert r["warp_mma"] == 8 * 2 * (r["block_m"] // wm // 16) * (
            r["block_n"] // wn // 8)
        assert r["slot_mma"] == r["waves"] * r["warp_mma"]
    # a deep bank: whole banks only with 32 channels a block
    deep = {(r["block_m"], r["block_n"]): r for r in tat.plan_block_mn(
        72, 72, n_steps=1000, wave_rows=1024)["candidates"]}
    assert deep[(32, 32)]["smem_bytes"] > deep[(32, 64)]["smem_bytes"]
    # one tile covers the whole stage: the fewest masked outputs win
    small = tat.plan_block_mn(16, 8, n_steps=3, wave_rows=4)
    assert (small["block_m"], small["block_n"]) == (32, 32)
    with pytest.raises(ValueError, match="fits"):
        tat.plan_block_mn(16, 8, candidates=(4096,))


def test_model_mode_and_slo_wait_for_their_items(monkeypatch, tmp_path):
    """Model mode has its cost model now (``repro_torch.costmodel``):
    explicit or through ``REPRO_AUTOTUNE=model`` it searches without a
    probe; ``slo_micro_batch`` still waits for the serving stack's
    ``repro_torch.serve.slo``."""
    _, tm = _pair("mlp")
    cfg = tat.autotune_model(tm, mode="model", directory=str(tmp_path),
                             force=True)
    assert cfg.source == "predicted" and cfg.probe_ms is None
    monkeypatch.setenv("REPRO_AUTOTUNE", "model")
    assert tat.autotune_model(tm, directory=str(tmp_path)) == cfg
    with pytest.raises(NotImplementedError, match="repro_torch.serve.slo"):
        tat.slo_micro_batch(tm, 5.0)


def test_compile_graph_autotune_flag_and_env_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path))
    graph = TGraph.from_json(_mlp_graph().to_json())
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    cm0 = tcompile(graph, in_scale=IN_SCALE, device="cpu", autotune=True)
    assert cm0.tuned is None
    monkeypatch.delenv("REPRO_AUTOTUNE")
    cm1 = tcompile(graph, in_scale=IN_SCALE, device="cpu", autotune=True)
    assert cm1.tuned is not None and cm1.tuned.source == "probed"
    assert cm1.tuned.seed_stage_ms is not None   # measured probes ran
    assert os.path.exists(tat.config_path(tat.schedule_key(cm1),
                                          str(tmp_path)))
    cm2 = tcompile(graph, in_scale=IN_SCALE, device="cpu", autotune=True)
    assert cm2.tuned == cm1.tuned
    cm3 = tcompile(graph, in_scale=IN_SCALE, device="cpu", tuned=cm1.tuned)
    assert cm3.tuned == cm1.tuned


def _state(cm):
    """What a probe pass runs: micro-batch aside, the dispatch mode and
    the dense stages' K1 tiles."""
    tiles = tuple((s.block_m, s.block_n) for s in cm.schedule.stages
                  if isinstance(s, FusedThresholdStage))
    return cm.megakernel, tiles


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_measured_decisions_time_candidates_in_turns(kind, tmp_path,
                                                     monkeypatch):
    """Each measured decision warms every candidate once, then runs
    PAIR_ROUNDS rounds of one pass per candidate in turn; every
    candidate's median and spread reach the config."""
    _, tm = _pair(kind)
    calls = []
    real = tm.streaming_compiled

    def logged(x, micro_batch=None):
        calls.append((int(micro_batch),) + _state(tm))
        return real(x, micro_batch=micro_batch)

    monkeypatch.setattr(tm, "streaming_compiled", logged)
    # a model tile other than the stages' default, so that the K1 pair is
    # timed (with the default tile there is nothing to time)
    real_plan = tat.plan_block_mn
    monkeypatch.setattr(tat, "plan_block_mn", lambda *a, **k: dict(
        real_plan(*a, **k), block_m=64, block_n=64))
    cfg = tat.autotune_model(tm, batch=32, directory=str(tmp_path),
                             force=True, topk=3)
    rounds = tat.PAIR_ROUNDS
    assert rounds >= 7
    top = [c for c in cfg.candidates if "probe_ms" in c]
    assert len(top) == 3
    arms = [(c["micro_batch"],) + _state(tm) for c in top]
    n = len(arms) * (rounds + 1)
    assert calls[:n] == arms * (rounds + 1)      # warm, then in turns
    for c in top:
        assert c["probe_rounds"] == rounds and c["probe_spread_ms"] >= 0
        assert cfg.probe_ms[str(c["micro_batch"])] == c["probe_ms"]
    rest = calls[n:]
    wave = cfg.micro_batch
    if kind == "mlp":                     # both pair decisions ran
        assert cfg.block_mn_probe and cfg.segment_mode_model
    if cfg.block_mn_probe:
        pair = rest[:2 * (rounds + 1)]
        rest = rest[2 * (rounds + 1):]
        assert all(c[0] == wave for c in pair)
        assert pair[0::2] == [pair[0]] * (rounds + 1)    # default tiles
        assert pair[1::2] == [pair[1]] * (rounds + 1)    # tuned tiles
        assert set(cfg.block_mn_probe["spread_ms"]) == {"default", "tuned"}
        assert cfg.block_mn_probe["rounds"] == rounds
    if cfg.segment_mode_model:
        assert [c[1] for c in rest] == [True, False] * (rounds + 1)
        assert all(c[0] == wave for c in rest)
        assert set(cfg.segment_mode_model["spread_ms"]) == {"megakernel",
                                                            "staged"}
        assert set(cfg.segment_mode_model["probe_ms"]) == {"megakernel",
                                                           "staged"}
    else:
        assert rest == []
    assert tm.megakernel is None          # probing restored the mode
    assert _state(tm) == (None, tuple((s.block_m, s.block_n)
                                      for s in _pair(kind)[1].schedule.stages
                                      if isinstance(s, FusedThresholdStage)))


def test_measured_k1_pair_is_not_timed_for_the_stages_own_tiles(
        tmp_path, monkeypatch):
    """When the model's tiles are the ones the stages run already, the
    measured K1 decision times nothing (the two arms would be one
    configuration, and noise would pick between them) and keeps them."""
    _, tm = _pair("mlp")
    calls = []
    real = tm.streaming_compiled

    def logged(x, micro_batch=None):
        calls.append((int(micro_batch),) + _state(tm))
        return real(x, micro_batch=micro_batch)

    monkeypatch.setattr(tm, "streaming_compiled", logged)
    cfg = tat.autotune_model(tm, batch=32, directory=str(tmp_path),
                             force=True, topk=3)
    assert cfg.block_mn and all(tuple(v) == tops.TMM_DEFAULT_TILE
                                for v in cfg.block_mn.values())
    assert cfg.block_mn_probe["pick"] == "tuned"
    assert "probe_ms" not in cfg.block_mn_probe
    rounds = tat.PAIR_ROUNDS
    n = 3 * (rounds + 1)                  # the micro-batch candidates
    rest = calls[n:]
    # only the megakernel-or-staged pair follows, if any
    assert len(rest) in (0, 2 * (rounds + 1))
    assert all(c[1] in (True, False) for c in rest)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_scripted_probe_calls_once_per_candidate_in_reference_order(
        kind, tmp_path):
    """Under ``probe=`` both packages call it once per candidate, in the
    same order, with the same micro-batch and dispatch mode."""
    jm, tm = _pair(kind)
    times = {mb: 0.010 + 0.0007 * abs(mb - 8) for mb in MBS}
    logs = {"j": [], "t": []}

    def logging(tag):
        def probe(cm, x, micro_batch):
            logs[tag].append((micro_batch, cm.megakernel))
            return times[micro_batch]
        return probe

    jat.autotune_model(jm, batch=32, probe=logging("j"),
                       directory=str(tmp_path / "j"), force=True)
    tat.autotune_model(tm, batch=32, probe=logging("t"),
                       directory=str(tmp_path / "t"), force=True)
    assert logs["t"] == logs["j"]
    assert len(logs["t"]) >= 3
