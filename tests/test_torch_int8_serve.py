"""The port's int8 serve path on the CPU against the JAX package.

Both sides get the same numbers: the port's ``Model.init`` (the
reference's distributions and tree; drawn by torch, which is quicker than
JAX's init) goes to the reference as numpy arrays, the reference's
``quantize_params`` tree comes back through ``params_from_numpy`` (float
leaves through float32 numpy, ``w_int`` codes as int8), and the same
numpy inputs go to both.

  * ``quantize_linear_params`` and ``Model.quantize_params``: ``w_int``
    and ``w_scale`` equal bit for bit, stacked ``blocks`` included; the
    router and the MoE's expert tensors are left as they are;
  * ``linear_apply``'s ``w_int`` branch (K5's plain version on the CPU)
    equal bit for bit on equal inputs, float32 and bf16;
  * the mamba ``dt_proj`` keeps its codes (it once passed only ``"w"``);
  * quantized prefill and decode on reduced llama3-8b, falcon-mamba-7b,
    qwen2-vl-2b and jamba-v0.1-52b (``CODE_RTOL``), K5 once a linear; the
    reference's bar on int8 against float top-1 agreement (>= 0.75);
  * greedy ``ServeEngine`` tokens equal the reference's int8 engine;
  * ``launch.serve --quant-bits 8`` and ``examples.serve_lm --quant``.

The JAX side is jitted so the suite stays quick.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.core.pytree import leaves_with_paths, tree_map
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serving.engine import Request, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["llama3-8b", "falcon-mamba-7b", "qwen2-vl-2b", "jamba-v0.1-52b"]
#: Quantized logits. The float32 paths that feed each activation
#: quantizer agree within float rounding (the logits within 5e-7 on these
#: inputs), so a code can flip only where x / s_x lies that close to a
#: rounding tie. A flipped int8 code moves what it feeds by one of its 127
#: steps, so the tolerance is the float tests' 1e-4 plus one step of the
#: logits' range, max|reference logit| / 127; a wrong scale, rounding or
#: layout moves the logits by many steps.
CODE_RTOL = 1e-4


def _np(tree):
    """numpy leaves: int8 codes kept, floats as float32."""
    return jax.tree.map(lambda x: np.asarray(x) if x.dtype == jnp.int8
                        else np.asarray(x, np.float32), tree)


@functools.lru_cache(maxsize=None)
def _quantized(name):
    """(JAX model, JAX float params, JAX int8 params, port model, port
    float params, port int8 params carried across)."""
    jm = JModel(jget_config(name).reduced())
    m = Model(get_config(name).reduced())
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), p)
    # eager: jitted, XLA divides the scales by 127 as a multiply by 1/127,
    # one ulp off in some; the port divides, as the eager reference does
    jq = jm.quantize_params(jp, bits=8)
    return jm, jp, jq, m, p, params_from_numpy(_np(jq), m.cfg, "cpu")


def _close(got, want):
    want = np.asarray(want)
    atol = CODE_RTOL + float(np.abs(want).max()) / 127
    np.testing.assert_allclose(got.numpy(), want, rtol=CODE_RTOL, atol=atol)


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        x = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        return {"tokens": jnp.asarray(x)}, {"tokens": torch.from_numpy(x)}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}


@pytest.mark.parametrize("shape,dtype,bits,bias", [
    ((48, 40), "float32", 8, False), ((32, 3, 8), "float32", 8, True),
    ((48, 40), "bfloat16", 8, True), ((40, 24), "float32", 4, False)])
def test_quantize_linear_params_matches_reference(shape, dtype, bits, bias):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    p = {"w": w}
    if bias:
        p["b"] = rng.standard_normal(shape[1:]).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = {k: jnp.asarray(v, jdt) for k, v in p.items()}
    want = jlayers.quantize_linear_params(jp, bits)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = tlayers.quantize_linear_params(
        {k: torch.from_numpy(np.asarray(v, np.float32)).to(tdt)
         for k, v in jp.items()}, bits)
    assert sorted(got) == sorted(want)
    assert got["w_int"].dtype == torch.int8 and got["w_scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["w_int"].numpy(),
                                  np.asarray(want["w_int"]))
    np.testing.assert_array_equal(got["w_scale"].numpy(),
                                  np.asarray(want["w_scale"]))
    assert tuple(got["w_scale"].shape) == (1,) + shape[1:]
    if bias:
        assert got["b"] is not None and got["b"].dtype == tdt


@pytest.mark.parametrize("dtype,x_shape", [
    ("float32", (2, 5)), ("float32", (3,)), ("bfloat16", (2, 5))])
def test_int8_linear_matches_reference_bit_for_bit(dtype, x_shape):
    """The reference's ``w_int`` branch on the same codes and input: the
    int32 products are exact and both multiply by ``s_x * w_scale``
    formed first, so the results are equal, not close. A (d, 3, 8) weight
    with a bias, a 3-D and a 2-D input; K5 launched once (its plain
    version on the CPU)."""
    jcfg = dataclasses.replace(jget_config("qwen1.5-4b").reduced(),
                               dtype=dtype)
    cfg = dataclasses.replace(get_config("qwen1.5-4b").reduced(), dtype=dtype)
    rng = np.random.default_rng(2)
    d = cfg.d_model
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq = jlayers.quantize_linear_params(
        {"w": jnp.asarray(rng.standard_normal((d, 3, 8)) * 0.1, jdt),
         "b": jnp.asarray(rng.standard_normal((3, 8)), jdt)}, 8)
    x = jnp.asarray(rng.standard_normal(x_shape + (d,)) * 2, jdt)
    want = np.asarray(jlayers.linear_apply(jcfg, jq, x), np.float32)
    tq = params_from_numpy(_np({"lin": jq}), cfg, "cpu")["lin"]
    calls = []
    real = ops.qmatmul
    try:
        ops.qmatmul = lambda *a, **k: calls.append(1) or real(*a, **k)
        got = tlayers.linear_apply(
            cfg, tq, torch.from_numpy(np.asarray(x, np.float32)).to(
                tq["b"].dtype))
    finally:
        ops.qmatmul = real
    assert len(calls) == 1 and got.dtype == tq["b"].dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", ARCHS)
def test_quantize_params_matches_reference(name):
    """Every leaf of the port's ``quantize_params`` of the carried float
    weights equals the reference's quantized tree carried across: codes,
    scales (per group of the stacked blocks), and the leaves left alone
    (router, expert tensors, norms, embed)."""
    jm, jp, jq, m, p, qn = _quantized(name)
    got = leaves_with_paths(m.quantize_params(p, bits=8))
    want = leaves_with_paths(qn)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    paths = dict(got)
    assert any(k.endswith("w_int") for k in paths)
    for k, t in paths.items():
        if k.endswith("w_int"):
            assert t.dtype == torch.int8 and t.shape[0] == m.cfg.n_groups \
                if k.startswith("blocks") else t.dtype == torch.int8
        if "router" in k or k.split("/")[-1] in ("wi_gate", "wi_up", "wo"):
            assert t.is_floating_point(), k      # left as they were
    if m.cfg.moe_experts:
        assert "blocks/sub1/moe/router/w" in paths
        assert "blocks/sub1/moe/wi_gate" in paths


@pytest.mark.parametrize("name", ARCHS)
def test_quantized_prefill_and_decode_match_reference(name):
    """Prefill of 2 x 16 and 6 decode steps (a per-slot index from the
    fourth) of the quantized model against the reference's, within
    ``CODE_RTOL``; K5 runs once a linear of the prefill (7 a dense
    attention layer, the mamba mixer's 4, the MoE's router stays float);
    then the reference's bar: int8 and float logits agree on the top-1
    token at >= 0.75 of positions."""
    jm, jp, jq, m, p, qn = _quantized(name)
    jb, tb = _inputs(m.cfg, 2, 16, 3)
    want = jax.jit(jm.prefill)(jq, jb)
    launches = ops.launches["qmatmul"]
    got = m.prefill(qn, tb)
    n_lin = sum(k.endswith("w_int") for k, _ in leaves_with_paths(qn)
                if k.startswith("blocks"))
    assert ops.launches["qmatmul"] - launches == 0      # CPU: plain version
    _close(got, want)
    calls = []
    real = ops.qmatmul
    try:
        ops.qmatmul = lambda *a, **k: calls.append(1) or real(*a, **k)
        m.prefill(qn, tb)
    finally:
        ops.qmatmul = real
    assert len(calls) == n_lin * m.cfg.n_groups + ("head" in qn)
    agree = float((got.argmax(-1) == m.prefill(p, tb).argmax(-1)).float()
                  .mean())
    assert agree >= 0.75, agree

    jdecode = jax.jit(jm.decode_step)
    jc = jm.cache_init(2, 16)
    tc = m.cache_init(2, 16, device="cpu")
    jstep, tstep = _inputs(m.cfg, 2, 6, 4)
    key = "tokens" if m.cfg.embed_inputs else "embeds"
    for t in range(6):
        cur = t if t < 3 else np.asarray([t, t + 2], np.int32)
        want, jc = jdecode(jq, jc, jstep[key][:, t:t + 1],
                           jnp.asarray(cur, jnp.int32))
        got, tc = m.decode_step(qn, tc, tstep[key][:, t:t + 1],
                                torch.as_tensor(cur))
        _close(got, want)


def test_mamba_dt_proj_keeps_its_int8_codes():
    """The mamba mixer's ``dt_proj`` goes through ``linear_apply`` with
    every leaf but its bias, as the reference passes it: its quantized
    form (``w_int``, ``w_scale``, no ``w``) runs on K5 in ``ssm_apply``
    and ``ssm_decode``, equal to the reference's mixer."""
    jm, jp, jq, m, p, qn = _quantized("falcon-mamba-7b")
    jsub = jax.tree.map(lambda a: a[0], jq["blocks"]["sub0"]["ssm"])
    tsub = {k: (v[0] if isinstance(v, torch.Tensor)
                else {kk: vv[0] for kk, vv in v.items()})
            for k, v in qn["blocks"]["sub0"]["ssm"].items()}
    assert sorted(tsub["dt_proj"]) == ["b", "w_int", "w_scale"]
    x = np.random.default_rng(5).standard_normal(
        (2, 8, m.cfg.d_model)).astype(np.float32)
    want = jax.jit(functools.partial(jssm.ssm_apply, jm.cfg))(
        jsub, jnp.asarray(x))
    _close(tssm.ssm_apply(m.cfg, tsub, torch.from_numpy(x)), want)
    jcache = jssm.ssm_cache_init(jm.cfg, 2)
    tcache = tssm.ssm_cache_init(m.cfg, 2)
    want, _ = jax.jit(functools.partial(jssm.ssm_decode, jm.cfg))(
        jsub, jnp.asarray(x[:, :1]), jcache)
    got, _ = tssm.ssm_decode(m.cfg, tsub, torch.from_numpy(x[:, :1]), tcache)
    _close(got, want)


def _serve(engine_cls, request_cls, model, params, requests, **kw):
    eng = engine_cls(model, params, **kw)
    reqs = [request_cls(uid=r["uid"], prompt=r["prompt"],
                        max_new_tokens=r["max_new_tokens"])
            for r in requests]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return reqs


def test_int8_serve_engine_matches_reference():
    """Four requests through two slots of the int8 llama3-8b: every
    request's greedy tokens equal the reference's int8 engine's; the
    decode bench's ``copy_params`` keeps the int8 codes as they are."""
    from repro_torch.bench.lm_decode import copy_params

    jm, jp, jq, m, p, qn = _quantized("llama3-8b")
    for inference in (False, True):
        for (_, a), (_, b) in zip(leaves_with_paths(copy_params(qn,
                                                                inference)),
                                  leaves_with_paths(qn)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    rng = np.random.default_rng(6)
    requests = [{"uid": i, "prompt": rng.integers(0, m.cfg.vocab, n).astype(
        np.int32), "max_new_tokens": 4} for i, n in enumerate((3, 5, 2, 4))]
    jreqs = _serve(JServeEngine, JRequest, jm, jq, requests, n_slots=2,
                   max_len=16)
    reqs = _serve(ServeEngine, Request, m, qn, requests, n_slots=2,
                  max_len=16, device="cpu")
    for r, jr in zip(reqs, jreqs):
        assert r.output == jr.output, (r.uid, r.output, jr.output)


def test_int8_launchers_run_on_the_cpu(capsys):
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve

    s = serve.main(["--quant-bits", "8", "--reduced", "--device", "cpu",
                    "--requests", "3", "--max-new", "3"])
    assert s["n_requests"] == 3 and s["throughput_tok_s"] > 0
    s = serve_lm.main(["--quant", "--device", "cpu", "--requests", "2",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "serving int8-quantized weights" in out and s["n_requests"] == 2
