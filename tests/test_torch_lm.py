"""The port's LM inference path on the CPU against the JAX package.

The reference's ``Model.init`` weights are carried across with
``params_from_numpy`` (every leaf through float32 numpy), and the same
numpy tokens go to both sides:

  * ``Model.prefill`` and ``Model.decode_step`` on ``llama3-8b`` reduced
    with ``attn_impl`` "chunked" (the K6 wrapper, its plain version on the
    CPU) and "naive", on ``h2o-danube-1.8b`` reduced (window 32, a
    ring-buffer cache that wraps) and on ``qwen1.5-4b`` reduced (q/k/v
    biases): float32 logits within 1e-4;
  * the layers (RMS and layer norm, biased linear, SwiGLU) on random
    parameters;
  * ``ServeEngine`` against the reference's engine, token for token,
    including EOS and slot reuse;
  * the carrier round trip, ``init``'s shapes and distributions, QAT
    weights (``weight_bits=8``) that build and train, and the int8 serve
    path's ``w_int`` params carried across (the path itself is held in
    ``test_torch_int8_serve.py``).

The other families (MoE, mamba, the hybrid, M-RoPE, embedding inputs) are
held against the reference in ``test_torch_families.py``.

The JAX side is jitted so the suite stays quick.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serving.engine import Request, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CASES = [("llama3-8b", "chunked"), ("llama3-8b", "naive"),
         ("h2o-danube-1.8b", "chunked"), ("qwen1.5-4b", "chunked")]


def _to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _pair(name, impl="auto", seed=0):
    """(JAX model, JAX params, port model, port params) with one set of
    weights: the reference's init, carried across."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), attn_impl=impl)
    cfg = dataclasses.replace(get_config(name).reduced(), attn_impl=impl)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, Model(cfg), params_from_numpy(_to_numpy(jp), cfg, "cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("name,impl", CASES)
def test_prefill_matches_reference(name, impl, monkeypatch):
    jm, jp, m, p = _pair(name, impl)
    toks = _tokens(1, (2, 64), m.cfg.vocab)
    want = np.asarray(jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}))
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = m.prefill(p, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    # one K6 call per layer on the chunked path, none on the naive one
    assert len(calls) == (m.cfg.n_layers if impl == "chunked" else 0)


@pytest.mark.parametrize("name,impl", CASES)
def test_decode_step_matches_reference(name, impl):
    """40 steps into a 48-long cache (h2o: a 32-slot ring that wraps), a
    scalar cur_index for 30 steps, then a per-slot vector."""
    jm, jp, m, p = _pair(name, impl)
    toks = _tokens(2, (2, 40), m.cfg.vocab)
    jdecode = jax.jit(jm.decode_step)
    jc = jm.cache_init(2, 48)
    tc = m.cache_init(2, 48, device="cpu")
    assert [tuple(x.shape) for x in jax.tree.leaves(jc)] == \
        [tuple(x.shape) for x in (tc["sub0"]["k"], tc["sub0"]["v"])]
    for t in range(40):
        cur = t if t < 30 else np.asarray([t, t], np.int32)
        want, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                           jnp.asarray(cur, jnp.int32))
        got, tc = m.decode_step(p, tc, torch.from_numpy(toks[:, t:t + 1]),
                                torch.as_tensor(cur))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["sub0"][key].numpy(),
                                   np.asarray(jc["sub0"][key]), **LOGIT_TOL)


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_layers_match_reference(norm):
    """norm_apply, a biased linear_apply and mlp_apply on random numpy
    parameters (the reference's inits give unit scales and zero biases)."""
    jcfg = dataclasses.replace(jget_config("qwen1.5-4b").reduced(), norm=norm)
    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduced(), norm=norm)
    rng = np.random.default_rng(4)
    d, f = cfg.d_model, cfg.d_ff
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    npar = {"norm": {"scale": rng.uniform(0.5, 1.5, d), "bias":
                     rng.standard_normal(d)},
            "lin": {"w": rng.standard_normal((d, 3, 8)) * 0.1,
                    "b": rng.standard_normal((3, 8))},
            "mlp": {k: {"w": rng.standard_normal(shape) * 0.1}
                    for k, shape in (("wi_gate", (d, f)), ("wi_up", (d, f)),
                                     ("wo", (f, d)))}}
    if norm == "rms":
        del npar["norm"]["bias"]
    npar = jax.tree.map(lambda a: np.asarray(a, np.float32), npar)
    tpar = params_from_numpy(npar, cfg, "cpu")
    tx = torch.from_numpy(x)
    for jfn, tfn, key in ((jlayers.norm_apply, tlayers.norm_apply, "norm"),
                          (jlayers.linear_apply, tlayers.linear_apply, "lin"),
                          (jlayers.mlp_apply, tlayers.mlp_apply, "mlp")):
        want = np.asarray(jfn(jcfg, npar[key], jnp.asarray(x)))
        got = tfn(cfg, tpar[key], tx)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def _serve(engine_cls, request_cls, model, params, requests, **kw):
    eng = engine_cls(model, params, **kw)
    reqs = [request_cls(uid=r["uid"], prompt=r["prompt"],
                        max_new_tokens=r["max_new_tokens"],
                        eos_id=r.get("eos_id")) for r in requests]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, reqs


@pytest.mark.parametrize("name", ["llama3-8b", "h2o-danube-1.8b"])
def test_serve_engine_matches_reference(name):
    """Five requests of mixed prompt lengths through two slots: slots are
    reused, and every request's tokens equal the reference engine's."""
    jm, jp, m, p = _pair(name)
    rng = np.random.default_rng(0)
    requests = [{"uid": i, "prompt": rng.integers(0, m.cfg.vocab, n).astype(
        np.int32), "max_new_tokens": 4 + i % 3}
        for i, n in enumerate((3, 5, 1, 4, 6))]
    jeng, jreqs = _serve(JServeEngine, JRequest, jm, jp, requests, n_slots=2,
                         max_len=40)
    eng, reqs = _serve(ServeEngine, Request, m, p, requests, n_slots=2,
                       max_len=40, device="cpu")
    assert len(eng.finished) == len(jeng.finished) == 5
    assert [r.uid for r in eng.finished] == [r.uid for r in jeng.finished]
    for r, jr in zip(reqs, jreqs):
        assert r.output == jr.output, (r.uid, r.output, jr.output)
    s = eng.stats()
    assert s["n_requests"] == 5 and s["throughput_tok_s"] > 0


def test_serve_engine_eos_frees_slot_like_reference():
    """EOS ends a request early and frees its slot for the next one; the
    port stops where the reference stops."""
    jm, jp, m, p = _pair("llama3-8b")
    first = {"uid": 0, "prompt": np.asarray([1, 2], np.int32),
             "max_new_tokens": 10}
    _, (probe,) = _serve(JServeEngine, JRequest, jm, jp, [first], n_slots=1,
                         max_len=16)
    eos = probe.output[2]
    requests = [dict(first, eos_id=eos),
                {"uid": 1, "prompt": np.asarray([7, 9, 11], np.int32),
                 "max_new_tokens": 3}]
    jeng, jreqs = _serve(JServeEngine, JRequest, jm, jp, requests, n_slots=1,
                         max_len=16)
    eng, reqs = _serve(ServeEngine, Request, m, p, requests, n_slots=1,
                       max_len=16, device="cpu")
    assert reqs[0].output[-1] == eos and len(reqs[0].output) < 10
    for r, jr in zip(reqs, jreqs):
        assert r.output == jr.output


def test_serve_engine_rejects_bad_prompts_and_devices():
    _, _, m, p = _pair("llama3-8b")
    eng = ServeEngine(m, p, n_slots=1, max_len=8, device="cpu")
    for prompt in (np.zeros(0, np.int32), np.zeros(9, np.int32)):
        with pytest.raises(ValueError):
            eng.submit(Request(uid=0, prompt=prompt))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ServeEngine(m, p)                 # the default device is the card


def test_params_from_numpy_keeps_shapes_and_values():
    jm, jp, m, p = _pair("h2o-danube-1.8b")
    jleaves = jax.tree_util.tree_leaves_with_path(_to_numpy(jp))
    assert len(jleaves) == len(jax.tree.leaves(p))
    for path, want in jleaves:
        got = p
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    # the stacked groups axis leads every block leaf
    assert p["blocks"]["sub0"]["attn"]["wq"]["w"].shape[0] == m.cfg.n_groups
    # a bf16 config gets bf16 leaves holding the same (bf16) values
    cfg16 = dataclasses.replace(m.cfg, dtype="bfloat16")
    jp16 = JModel(dataclasses.replace(jm.cfg, dtype="bfloat16")).init(
        jax.random.PRNGKey(0))
    p16 = params_from_numpy(_to_numpy(jp16), cfg16, "cpu")
    np.testing.assert_array_equal(
        p16["embed"]["table"].float().numpy(),
        np.asarray(jp16["embed"]["table"], np.float32))


def test_init_matches_reference_shapes_and_scales():
    jm, jp, m, _ = _pair("llama3-8b")
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    again = m.init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jp)

    def walk(t, j, a):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j)
            for k in t:
                walk(t[k], j[k], a[k])
        else:
            assert tuple(t.shape) == j and torch.equal(t, a)

    walk(p, jshapes, again)
    wq = p["blocks"]["sub0"]["attn"]["wq"]["w"].float()
    std = m.cfg.d_model ** -0.5
    assert wq.abs().max() <= 2 * std + 1e-6            # truncated at 2 sigma
    assert abs(float(wq.std()) / (0.88 * std) - 1) < 0.1
    emb = p["embed"]["table"].float()
    assert abs(float(emb.std()) / std - 1) < 0.1


def test_qat_trains_and_quantized_reference_tree_carries_across():
    """QAT (``weight_bits=8``, fake-quant weights) builds and trains; the
    reference's ``quantize_params`` tree carries across: ``w_int`` stays
    int8 (float codes are refused), ``w_scale`` is float32, the rest
    keeps the reference's dtypes."""
    cfg = get_config("llama3-8b").reduced()
    m = Model(dataclasses.replace(cfg, weight_bits=8))
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(3, (2, 17), cfg.vocab))
    flat = jax.tree.leaves(p)
    for t in flat:
        t.requires_grad_(True)
    loss, _ = m.loss(p, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    grads = torch.autograd.grad(loss, flat)
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    assert all(float(g.abs().max()) > 0 for g in grads)
    jm = JModel(jget_config("llama3-8b").reduced())
    jq = jm.quantize_params(jm.init(jax.random.PRNGKey(0)))
    q = params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x) if x.dtype == jnp.int8
        else np.asarray(x, np.float32), jq), cfg, "cpu")
    wq = q["blocks"]["sub0"]["attn"]["wq"]
    assert sorted(wq) == ["w_int", "w_scale"] and "w_int" in q["head"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(jq):
        got = q
        for key in path:
            got = got[key.key]
        want = {"w_int": torch.int8, "w_scale": torch.float32}.get(
            path[-1].key, torch.float32)
        assert got.dtype == want, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    with pytest.raises(TypeError):         # float codes are not int8 codes
        params_from_numpy(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                       jq), cfg, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Model(cfg).init(torch.Generator())   # the default is the card


def test_init_under_inference_mode_decodes_like_ordinary_params():
    """``init`` makes ordinary tensors (training takes their gradients);
    under ``inference_mode``, as the serving callers call it, inference
    tensors. From one generator seed both hold the same numbers and decode
    to the same logits, bit for bit."""
    cfg = get_config("llama3-8b").reduced()
    m = Model(cfg)
    plain = m.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        served = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert not any(t.is_inference() for t in jax.tree.leaves(plain))
    assert all(t.is_inference() for t in jax.tree.leaves(served))
    tok = torch.from_numpy(_tokens(4, (2, 1), cfg.vocab))
    cur = torch.tensor([3, 9], dtype=torch.int32)
    outs = []
    for p in (plain, served):
        cache = m.cache_init(2, 16, device="cpu")
        logits, _ = m.decode_step(p, cache, tok, cur)
        outs.append(logits)
    assert torch.equal(outs[0], outs[1])


def test_lm_decode_bench_times_both_parameter_kinds():
    """``bench.lm_decode`` on the CPU at the reduced size: one round of
    each parameter kind, finite medians."""
    from repro_torch.bench import lm_decode

    res = lm_decode.run("llama3-8b", True, "cpu", rounds=2, steps=2)
    assert res["card"] == "cpu"
    for kind in ("ordinary", "inference"):
        assert len(res[f"{kind}_ms"]) == 2
        assert np.isfinite(res[f"{kind}_median_ms"])
        assert res[f"{kind}_median_ms"] > 0
