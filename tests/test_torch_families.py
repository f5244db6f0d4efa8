"""Every LM family of the repo through the port's entry points, on the CPU,
against the JAX package.

The reference's ``Model.init`` weights are carried across with
``params_from_numpy``; the same numpy-seeded inputs go to both sides, in
float32 (the ``reduced()`` configs), tolerance 1e-4 (``LOGIT_TOL``):

  * ``Model.prefill`` and ``Model.decode_step`` for every configuration
    of ``list_configs()``: tokens, or embeddings for qwen2-vl and hubert;
    (3, B, S) M-RoPE positions that are not an arange for qwen2-vl; decode
    with a scalar ``cur_index``, then a per-slot vector; the caches (KV,
    conv windows, float32 states) equal the reference's after the steps;
  * ``Model.loss`` and every gradient against ``jax.grad`` for jamba,
    llama4-scout and falcon-mamba (each leaf within 1e-4 of its largest
    |reference gradient|);
  * M-RoPE: ``mrope_cos_sin``; ``attn_apply`` with non-arange (3, B, S)
    positions on the naive path, and on the chunked path (the K6 wrapper)
    with an arange temporal row and other h / w rows;
  * ``ServeEngine`` against the reference's engine, token for token, on
    reduced jamba and falcon-mamba with 4 slots and 7 requests (slots
    reused; jamba's MoE drops choices at the decode batch);
  * leaf dtypes of ``Model.init`` and ``params_from_numpy`` on a bf16
    reduced jamba equal ``jax.eval_shape`` of the reference's init: the
    router, ``A_log``, ``D`` and ``dt_proj.b`` stay float32;
  * the engine refuses a config that takes embeddings; the launchers run
    jamba reduced.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, list_configs
from repro_torch.core.pytree import leaves, leaves_with_paths
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serving.engine import Request, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-4          # of each leaf's largest |reference gradient|


def _to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _pair(name, seed=0, **over):
    """(JAX model, JAX params, port model, port params), one set of
    weights: the reference's init, carried across."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, Model(cfg), params_from_numpy(_to_numpy(jp), cfg, "cpu")


def _mrope_positions(rng, B, S, arange_t=False):
    """(3, B, S): a temporal row (an arange run, or jittered increasing
    positions) and h / w rows of a patch grid."""
    t = np.broadcast_to(np.arange(S), (B, S))
    if not arange_t:
        t = np.cumsum(rng.integers(0, 3, (B, S)), axis=1)
    h = rng.integers(0, 8, (B, S))
    w = rng.integers(0, 8, (B, S))
    return np.stack([t, h, w]).astype(np.int32)


def _inputs(cfg, B, S, seed):
    """The batch one side takes: tokens, or embeddings (and M-RoPE
    positions) for the vlm / audio backbones."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)}
    else:
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)}
    if cfg.mrope:
        batch["positions"] = _mrope_positions(rng, B, S)
    return batch


@pytest.mark.parametrize("name", list_configs())
def test_prefill_matches_reference(name):
    jm, jp, m, p = _pair(name)
    batch = _inputs(m.cfg, 2, 32, 1)
    want = np.asarray(jax.jit(jm.prefill)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = m.prefill(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("name", list_configs())
def test_decode_step_matches_reference(name):
    """20 steps into a 24-long cache: a scalar cur_index for 12 steps, then
    a per-slot vector; every step's logits and the caches after them."""
    jm, jp, m, p = _pair(name)
    cfg = m.cfg
    inp = _inputs(cfg, 2, 20, 2)
    x = inp["tokens"] if cfg.embed_inputs else inp["embeds"]
    jdecode = jax.jit(jm.decode_step)
    jc = jm.cache_init(2, 24)
    tc = m.cache_init(2, 24, device="cpu")
    for t in range(20):
        cur = t if t < 12 else np.asarray([t, t], np.int32)
        want, jc = jdecode(jp, jc, jnp.asarray(x[:, t:t + 1]),
                           jnp.asarray(cur, jnp.int32))
        got, tc = m.decode_step(p, tc, torch.from_numpy(x[:, t:t + 1]),
                                torch.as_tensor(cur))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    jleaves = jax.tree_util.tree_leaves_with_path(jc)
    assert len(jleaves) == len(leaves(tc))
    for path, want in jleaves:
        got = tc
        for key in path:
            got = got[key.key]
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)


def _port_grads(m, p, batch):
    flat = leaves(p)
    for x in flat:
        x.requires_grad_(True)
    loss, metrics = m.loss(p, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    return loss.detach(), metrics, torch.autograd.grad(loss, flat)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "llama4-scout-17b-16e",
                                  "falcon-mamba-7b"])
def test_loss_and_gradients_match_reference(name):
    jm, jp, m, p = _pair(name)
    batch = SyntheticTokens(vocab=m.cfg.vocab, seq_len=32).batch(0, 2)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_grads(m, p, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("ce", "z_loss", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jaux[k]),
                                   rtol=1e-5, atol=1e-9)
    if m.cfg.is_moe:
        assert float(metrics["aux"]) > 0
    want = jax.tree.leaves(jg)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-30))


def test_mrope_cos_sin_matches_reference():
    jcfg = jget_config("qwen2-vl-2b").reduced()
    cfg = get_config("qwen2-vl-2b").reduced()
    pos = _mrope_positions(np.random.default_rng(3), 2, 40)
    wc, ws = jattn.mrope_cos_sin(jcfg, jnp.asarray(pos))
    c, s = tattn.mrope_cos_sin(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6,
                               atol=1e-6)
    # a (B, S) text-only input is (3, B, S) with equal rows
    c2, s2 = tattn.positions_cos_sin(cfg, torch.from_numpy(pos[0]))
    c3, s3 = tattn.positions_cos_sin(
        cfg, torch.from_numpy(np.stack([pos[0]] * 3)))
    assert torch.equal(c2, c3) and torch.equal(s2, s3)
    with pytest.raises(ValueError, match="sum to head_dim"):
        tattn.mrope_cos_sin(dataclasses.replace(cfg, mrope_sections=(1, 2, 3)),
                            torch.from_numpy(pos))


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_mrope_attention_matches_reference(impl, monkeypatch):
    """``attn_apply`` of qwen2-vl reduced (q/k/v biases, GQA 4/2) at S 64:
    naive with non-arange temporal positions, chunked (two 32-row blocks
    through the K6 wrapper) with an arange temporal row; h / w rows vary
    in both."""
    jcfg = dataclasses.replace(jget_config("qwen2-vl-2b").reduced(),
                               attn_impl=impl)
    cfg = dataclasses.replace(get_config("qwen2-vl-2b").reduced(),
                              attn_impl=impl)
    jp = jattn.attn_init(jax.random.PRNGKey(4), jcfg)
    p = params_from_numpy(_to_numpy(jp), cfg, "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    pos = _mrope_positions(rng, 2, 64, arange_t=impl == "chunked")
    assert (pos[1] != pos[0]).any() and (pos[2] != pos[0]).any()
    want = np.asarray(jattn.attn_apply(jcfg, jp, jnp.asarray(x),
                                       jnp.asarray(pos)))
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tattn.attn_apply(cfg, p, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert len(calls) == (1 if impl == "chunked" else 0)
    if impl == "chunked":        # the kernel takes arange positions only
        bad = pos.copy()
        bad[0, :, 5] += 1
        with pytest.raises(ValueError, match="arange"):
            tattn.attn_apply(cfg, p, torch.from_numpy(x),
                             torch.from_numpy(bad))


def _serve(engine_cls, request_cls, model, params, requests, **kw):
    eng = engine_cls(model, params, **kw)
    reqs = [request_cls(uid=r["uid"], prompt=r["prompt"],
                        max_new_tokens=r["max_new_tokens"])
            for r in requests]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng, reqs


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "falcon-mamba-7b"])
def test_serve_engine_matches_reference(name, monkeypatch):
    """Seven requests of mixed prompt lengths through 4 slots: slots are
    reused, and every request's tokens equal the reference engine's. On
    jamba the 4-slot decode batch drops MoE choices (capacity 2 a expert
    for 8 choices over 4 experts)."""
    jm, jp, m, p = _pair(name)
    rng = np.random.default_rng(0)
    requests = [{"uid": i, "prompt": rng.integers(0, m.cfg.vocab, n).astype(
        np.int32), "max_new_tokens": 5 + i % 4}
        for i, n in enumerate((3, 6, 1, 4, 7, 2, 5))]
    drops = []
    real = tfm.moe_apply

    def counting(cfg, sub, h):
        if h.shape[0] == 4:
            _, _, idx = tlayers.moe_route(cfg, sub, h)
            per = torch.bincount(idx.reshape(-1), minlength=cfg.moe_experts)
            drops.append(int((per - tlayers.moe_capacity(cfg, 4))
                             .clamp_min(0).sum()))
        return real(cfg, sub, h)

    monkeypatch.setattr(tfm, "moe_apply", counting)
    jeng, jreqs = _serve(JServeEngine, JRequest, jm, jp, requests, n_slots=4,
                         max_len=40)
    eng, reqs = _serve(ServeEngine, Request, m, p, requests, n_slots=4,
                       max_len=40, device="cpu")
    assert len(eng.finished) == len(jeng.finished) == len(requests)
    assert [r.uid for r in eng.finished] == [r.uid for r in jeng.finished]
    for r, jr in zip(reqs, jreqs):
        assert r.output == jr.output, (r.uid, r.output, jr.output)
    if m.cfg.is_moe:
        assert sum(drops) > 0


def test_serve_engine_keeps_bf16_cache_dtypes():
    """A bf16 reduced jamba served through 4 slots: the conv windows and
    KV caches stay bf16 and the mamba states float32 after every slot
    write; a slot's state is its batch-1 prefill's."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              dtype="bfloat16")
    m = Model(cfg)
    with torch.inference_mode():
        p = m.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(m, p, n_slots=4, max_len=16, device="cpu")
    one, _ = eng._prefill_one(np.asarray([5, 9, 2], np.int32))
    eng.submit(Request(uid=0, prompt=np.asarray([5, 9, 2], np.int32),
                       max_new_tokens=3))
    eng.step()                               # insert into slot 0, decode
    eng.run_until_drained()
    assert eng.finished[0].output
    held = dict(leaves_with_paths(one))
    for path, leaf in leaves_with_paths(eng.caches):
        want = torch.float32 if path.endswith("/h") else torch.bfloat16
        assert leaf.dtype == want == held[path].dtype, path


def test_serve_engine_writes_the_prefill_state_into_the_slot():
    """The slot's mamba conv windows and states equal the batch-1
    prefill's bit for bit right after the insert."""
    _, _, m, p = _pair("jamba-v0.1-52b")
    eng = ServeEngine(m, p, n_slots=4, max_len=16, device="cpu")
    prompt = np.asarray([5, 9, 2, 7], np.int32)
    one, _ = eng._prefill_one(prompt)
    eng._insert_into_slot(2, Request(uid=0, prompt=prompt,
                                     max_new_tokens=4))
    held = dict(leaves_with_paths(one))
    n = 0
    for path, leaf in leaves_with_paths(eng.caches):
        if path.rsplit("/", 1)[-1] in ("h", "conv"):
            assert torch.equal(leaf[:, 2], held[path][:, 0]), path
            assert not leaf[:, 2].eq(0).all(), path
            n += 1
    assert n == 2 * 7                        # 7 mamba sublayers a block


def test_serve_engine_refuses_configs_that_take_embeddings():
    for name in ("qwen2-vl-2b", "hubert-xlarge"):
        _, _, m, p = _pair(name)
        with pytest.raises(ValueError, match="embeddings"):
            ServeEngine(m, p, n_slots=1, max_len=8, device="cpu")


def test_bf16_leaf_dtypes_match_reference():
    """On a bf16 reduced jamba, ``Model.init`` and ``params_from_numpy`` give
    every leaf the dtype of ``jax.eval_shape`` of the reference's init."""
    jcfg = dataclasses.replace(jget_config("jamba-v0.1-52b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              dtype="bfloat16")
    jm = JModel(jcfg)
    shapes = jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    init = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    carried = params_from_numpy(_to_numpy(jm.init(jax.random.PRNGKey(0))),
                                cfg, "cpu")
    f32 = set()
    for tree in (init, carried):
        got = dict(leaves_with_paths(tree))
        assert len(got) == len(shapes)
        for path, want in shapes:
            key = "/".join(k.key for k in path)
            assert tuple(got[key].shape) == want.shape, key
            assert str(got[key].dtype).replace("torch.", "") == \
                str(want.dtype), key
            if got[key].dtype == torch.float32:
                f32.add(key.split("/", 2)[-1])
    assert f32 == {"moe/router/w", "ssm/A_log", "ssm/D", "ssm/dt_proj/b"}


def test_launchers_run_jamba_reduced(tmp_path):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    s = launch_serve.main(["--arch", "jamba-v0.1-52b", "--reduced",
                           "--requests", "3", "--max-new", "3",
                           "--device", "cpu"])
    assert s["n_requests"] == 3
    # the loop logs its metrics every 10 steps
    res = launch_train.main(["--arch", "jamba-v0.1-52b", "--reduced",
                             "--steps", "10", "--batch", "2", "--seq", "16",
                             "--device", "cpu", "--ckpt-dir",
                             str(tmp_path)])
    assert res.final_step == 10
    assert np.isfinite(res.metrics_history[-1]["loss"])
