"""The port's LM training stack on the CPU against the JAX package.

The reduced ``internlm2-1.8b`` config (2 layers, d_model 64, 4 heads / 2
KV heads, head dim 16, vocab 256) in float32; the reference's
``Model.init`` weights are carried across with ``params_from_numpy`` and
the same numpy batches (``SyntheticTokens``) go to both sides:

  * ``Model.loss`` and every parameter gradient on both ``attn_impl``
    branches ("naive": plain torch ops; "chunked": K6 as an autograd
    function, its plain forward and plain backward on the CPU), and with
    QAT fake-quant at ``weight_bits`` 8 and 4: loss within rtol 1e-5,
    each gradient leaf within 1e-5 of its largest |element| (measured:
    1.5e-6);
  * K6's backward (``ops.flash_attention`` under autograd) against
    ``jax.vjp`` of the reference's ``chunked_attention`` with GQA, a
    window and a query offset: within 1e-5 of the largest |gradient|; a
    row with no live key gets zero gradients;
  * the remat modes: the gradients under "full", "dots" and
    "dots_saveable" equal "none" bit for bit, and the backward recomputes
    K6's forward where the policy says so;
  * the AdamW update, the global-norm clip and the cosine LR against the
    reference's functions (within 1e-6), and whole train steps with 1
    and 2 microbatches against the reference's (loss and metrics within
    rtol 1e-5, updated parameters within 2e-5 absolute, m and v within
    1e-7);
  * ``run_training``: a crash and resume equals an uninterrupted run bit
    for bit; the straggler watchdog under an injected ``time_fn`` fires
    at the reference's step; an exception inside the in-place update is
    not saved;
  * ``DataPipeline``: order, close and resume, against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train.steps import TrainState as JTrainState
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.core.pytree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.optim import adamw
from repro_torch.train import loop as tloop
from repro_torch.train.loop import LoopConfig, TornStateError, run_training
from repro_torch.train.steps import TrainState, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "internlm2-1.8b"
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5          # of each leaf's largest |reference gradient|


def _to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _pair(seed=0, **over):
    """(JAX model, JAX params, port model, port params), one set of
    weights."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), **over)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **over)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, Model(cfg), params_from_numpy(_to_numpy(jp), cfg, "cpu")


def _batch(cfg, step=0, batch=4, seq=64):
    return SyntheticTokens(vocab=cfg.vocab, seq_len=seq).batch(step, batch)


def _port_grads(m, p, batch):
    flat = leaves(p)
    for x in flat:
        x.requires_grad_(True)
    loss, metrics = m.loss(p, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), metrics, grads


def _assert_grads_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale)


@pytest.mark.parametrize("impl,bits", [("naive", 16), ("chunked", 16),
                                       ("chunked", 8), ("naive", 4)])
def test_loss_and_gradients_match_reference(impl, bits):
    jm, jp, m, p = _pair(attn_impl=impl, weight_bits=bits)
    batch = _batch(m.cfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    ops.flash_attention = counting
    try:
        loss, metrics, grads = _port_grads(m, p, batch)
    finally:
        ops.flash_attention = real
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    for k in ("ce", "z_loss", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, atol=1e-9)
    _assert_grads_close(grads, jax.tree.leaves(jg))
    # the chunked branch goes through K6 once a layer, and once more in the
    # backward's recompute (remat "full"); the naive one never
    assert len(calls) == (2 * m.cfg.n_layers if impl == "chunked" else 0)


def test_loss_masks_negative_labels_like_reference():
    jm, jp, m, p = _pair()
    batch = _batch(m.cfg)
    batch["labels"][:, ::3] = -1
    jl, _ = jax.jit(jm.loss)(jp, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    loss, _, _ = _port_grads(m, p, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)


def _qkv(seed, h, hkv, sq, sk):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, sq, h, 16), (2, sk, hkv, 16), (2, sk, hkv, 16),
                          (2, sq, h, 16))]


@pytest.mark.parametrize("h,hkv,sq,sk,window,q_offset,chunk", [
    (4, 2, 64, 64, 0, 0, 32),    # GQA, causal, 2 x 2 blocks
    (4, 1, 64, 64, 16, 0, 32),   # 4 query heads a KV head, window 16
    (4, 2, 32, 64, 0, 32, 64),   # a query chunk at offset 32, one key block
])
def test_flash_backward_matches_reference_vjp(h, hkv, sq, sk, window,
                                              q_offset, chunk):
    """K6 under autograd on the CPU (plain forward with lse, plain
    backward) against ``jax.vjp`` of the reference's ``chunked_attention``
    (its jnp flash twin, which JAX differentiates). At a query offset the
    key chunk spans Sk: the reference skips key blocks by block index
    alone (the next test)."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), window=window,
                               attn_chunk=chunk)
    q, k, v, do = _qkv(h * 100 + sq + window + q_offset, h, hkv, sq, sk)
    q_pos = jnp.arange(sq, dtype=jnp.int32) + q_offset
    k_pos = jnp.arange(sk, dtype=jnp.int32)
    out, vjp = jax.vjp(
        lambda a, b, c: jattn.chunked_attention(jcfg, a, b, c, q_pos, k_pos),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    got_out = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                  tv.transpose(1, 2), causal=True,
                                  window=window, q_offset=q_offset)
    np.testing.assert_allclose(got_out.transpose(1, 2).detach().numpy(),
                               np.asarray(out), rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(got_out, (tq, tk, tv),
                              torch.from_numpy(do).transpose(1, 2))
    _assert_grads_close(got, want)


def test_reference_chunked_attention_skips_live_blocks_at_a_query_offset():
    """A finding, not a port fault: the reference's ``live_block_pairs``
    places query block i at positions i * cq.., ignoring q_pos, so at a
    query offset it drops causal key blocks that hold live keys and its
    chunked attention disagrees with its own dense path. The port's K6
    takes the offset as the kernel's ``q_offset`` and equals the dense
    path."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), attn_chunk=32)
    q, k, v, _ = _qkv(5, 4, 2, 32, 64)
    q_pos = jnp.arange(32, dtype=jnp.int32) + 32
    k_pos = jnp.arange(64, dtype=jnp.int32)
    chunked = np.asarray(jattn.chunked_attention(jcfg, q, k, v, q_pos, k_pos))
    dense = np.asarray(jattn.naive_attention(
        q, k, v, jattn.mask_bias(jcfg, q_pos, k_pos)))
    assert np.abs(chunked - dense).max() > 0.1
    got = ops.flash_attention(*(torch.from_numpy(x).transpose(1, 2)
                                for x in (q, k, v)), causal=True, q_offset=32)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), dense, rtol=1e-5,
                               atol=1e-5)


def test_flash_backward_row_without_live_key_is_zero():
    """Causal with q_offset -3: query rows 0-2 see no key. Their output
    is 0 (the forward's rule), their gradients are 0, and the other rows'
    gradients equal autograd through a dense masked softmax."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(1, 2, 12, 16, generator=g, dtype=torch.float64)
    k = torch.randn(1, 2, 12, 16, generator=g, dtype=torch.float64)
    v = torch.randn(1, 2, 12, 16, generator=g, dtype=torch.float64)
    do = torch.randn(1, 2, 12, 16, generator=g, dtype=torch.float64)
    leaves32 = [t.float().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves32, causal=True, q_offset=-3)
    dq, dk, dv = torch.autograd.grad(out, leaves32, do.float())
    assert torch.equal(out[:, :, :3], torch.zeros_like(out[:, :, :3]))
    assert torch.equal(dq[:, :, :3], torch.zeros_like(dq[:, :, :3]))
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
    # dense reference on the rows that have keys (rows 3..11)
    q64, k64, v64 = (t.clone().requires_grad_(True) for t in (q, k, v))
    s = q64[:, :, 3:] @ k64.transpose(-1, -2) * 16 ** -0.5
    qpos = torch.arange(3, 12)[:, None] - 3
    s = s.masked_fill(torch.arange(12)[None, :] > qpos, float("-inf"))
    want_out = torch.softmax(s, dim=-1) @ v64
    want = torch.autograd.grad(want_out, (q64, k64, v64), do[:, :, 3:])
    for got_t, want_t in zip((dq, dk, dv), want):
        torch.testing.assert_close(got_t.double(), want_t, rtol=1e-5,
                                   atol=1e-5)
    # kv_len 0: no row sees a key, every gradient is 0
    out0 = ops.flash_attention(*leaves32, causal=False, kv_len=0)
    for t in torch.autograd.grad(out0, leaves32, do.float()):
        assert torch.equal(t, torch.zeros_like(t))


def _bf16_bwd_kernel_numerics(q, k, v, o, lse, do, *, causal, window,
                              q_offset, kv_len, round_ops=True):
    """K6's bf16 backward (``csrc/flash_attention_bwd.cu``, the tensor-core
    route) in plain tensor ops: bf16 inputs widened to float32, delta, S,
    P and dP in float32, P and dS rounded to bf16 before the three
    products that take them (dV = P^T dO, dK = dS^T Q, dQ = dS K: the
    tensor cores' register A operands), float32 sums, the gradients
    rounded to bf16 once. ``round_ops=False`` keeps every value in
    float32: then it is the explicit backward of the plain version."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    g = h // hkv
    qf, of, dof = (t.float().reshape(b, hkv, g, sq, d) for t in (q, o, do))
    kf, vf = k.float(), v.float()
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(sk)[None, :]
    live = kpos < kv_len
    if causal:
        live = live & (kpos <= qpos)
    if window > 0:
        live = live & (kpos > qpos - window)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * d ** -0.5
    p = torch.where(live, torch.exp(s - lse.reshape(b, hkv, g, sq, 1)), 0.0)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
    if round_ops:
        p, ds = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * d ** -0.5
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * d ** -0.5
    out_dtype = torch.bfloat16 if round_ops else torch.float32
    return tuple(t.to(out_dtype) for t in (dq.reshape(b, h, sq, d), dk, dv))


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,q_offset,kv_len", [
    (2, 4, 4, 65, 65, 16, True, 0, 0, None),        # GQA 1, a tile edge
    (1, 4, 2, 129, 129, 80, True, 32, 0, None),     # a window
    (2, 4, 2, 17, 95, 128, True, 0, 78, None),      # a decode chunk
    (1, 4, 2, 63, 127, 128, False, 40, 50, 100),    # window, offset, kv_len
    (1, 4, 1, 64, 64, 80, False, 0, 0, None),       # GQA 4
    (1, 2, 2, 5, 5, 16, True, 0, -3, None),         # rows with no live key
    (1, 4, 2, 64, 64, 128, True, 0, 0, 0),          # kv_len 0
    (1, 4, 2, 128, 128, 128, True, 0, 0, None)])
def test_flash_bf16_backward_numerics_within_the_tolerance(
        b, h, hkv, sq, sk, d, causal, window, q_offset, kv_len):
    """The tensor-core backward rounds P and dS to bf16 before its three
    register-operand products, the plain version does not: on seeded
    inputs the emulated kernel stays within the 2e-2 of the largest
    |gradient| that the card holds K6's backward to against the plain
    version (``FLASH_BWD_TOL``), over ``FLASH_BWD_CASES``' masks at small
    size. Without the roundings the emulation is the float32 plain
    backward, which ``test_flash_backward_matches_reference_vjp`` holds
    against ``jax.vjp`` of the reference's ``chunked_attention``."""
    rng = np.random.default_rng(sq * 7 + sk + d + h)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32))
                   for shape in ((b, h, sq, d), (b, hkv, sk, d),
                                 (b, hkv, sk, d), (b, h, sq, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              kv_len=kv_len)
    kv = sk if kv_len is None else kv_len
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, GRAD_TOL)):
        qd, kd, vd, dod = (t.to(dtype) for t in (q, k, v, do))
        out, lse = ops._flash_forward(qd, kd, vd, causal, window, q_offset,
                                      kv, want_lse=True)
        want = ops.flash_attention_bwd(qd, kd, vd, out, lse, dod, **kw)
        got = _bf16_bwd_kernel_numerics(
            qd, kd, vd, out, lse, dod, round_ops=dtype == torch.bfloat16,
            **kw)
        for g_t, w_t in zip(got, want):
            assert g_t.dtype == w_t.dtype == dtype
            assert g_t.shape == w_t.shape
            scale = max(float(w_t.float().abs().max()), 1e-30)
            err = float((g_t.float() - w_t.float()).abs().max())
            assert err <= tol * scale, (dtype, err, scale)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_every_remat_mode_gives_the_same_gradients(impl, monkeypatch):
    """"none", "full", "dots" and "dots_saveable" differ only in what the
    backward recomputes: losses and gradients equal bit for bit. On the
    chunked branch "full" and the selective modes recompute each layer's
    K6 forward once in the backward (2 forwards a layer), "none" does
    not."""
    _, _, m0, p = _pair(attn_impl=impl)
    batch = _batch(m0.cfg)
    forwards = []
    real = ops._flash_forward
    monkeypatch.setattr(ops, "_flash_forward",
                        lambda *a, **kw: forwards.append(1) or real(*a, **kw))
    results = {}
    for mode in ("none", "full", "dots", "dots_saveable"):
        m = Model(dataclasses.replace(m0.cfg, remat=mode))
        fresh = tree_map(lambda t: t.detach().clone(), p)
        forwards.clear()
        results[mode] = _port_grads(m, fresh, batch)
        n_layers = m.cfg.n_layers
        if impl == "chunked":
            assert len(forwards) == n_layers * (1 if mode == "none" else 2)
    loss0, _, g0 = results["none"]
    for mode, (loss, _, grads) in results.items():
        assert torch.equal(loss, loss0), mode
        for a, b in zip(grads, g0):
            assert torch.equal(a, b), mode


def test_adamw_update_clip_and_schedule_match_reference():
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 2)}}
    mk = lambda scale: jax.tree.map(  # noqa: E731
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    params, g1, g2 = mk(1.0), mk(0.3), mk(3.0)
    tt = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    # the cosine schedule at warmup, peak, decay and floor
    jlr = jadamw.cosine_schedule(3e-4, 10, 100)
    lr = adamw.cosine_schedule(3e-4, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(lr(torch.tensor(s))),
                                   float(jlr(jnp.asarray(s))), rtol=1e-6)
    # the clip, below and above the bound
    for max_norm in (100.0, 1.0):
        jc, jgn = jadamw.clip_by_global_norm(g2, max_norm)
        c, gn = adamw.clip_by_global_norm(tt(g2), max_norm)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
        for a, b in zip(leaves(c), jax.tree.leaves(jc)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # two optimizer steps (clip, schedule, update) on the same gradients
    jopt = jadamw.make_optimizer(base_lr=1e-2, warmup=1, total=10)
    opt = adamw.make_optimizer(base_lr=1e-2, warmup=1, total=10)
    jp, js = params, jopt.init(params)
    p = tt(params)
    s = opt.init(p)
    for g in (g1, g2):
        jp, js, jm = jopt.update(g, js, jp)
        p, s, met = opt.update(tt(g), s, p)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jm[k]),
                                       rtol=1e-6)
    assert int(s.step) == int(js.step) == 2 and s.step.dtype == torch.int32
    for got, want in ((p, jp), (s.m, js.m), (s.v, js.v)):
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """One whole step (loss -> grads -> clip -> AdamW), with the
    gradients of 2 microbatches summed in float32 and averaged."""
    jm, jp, m, p = _pair()
    jopt = jadamw.make_optimizer(base_lr=1e-3, warmup=1, total=10)
    opt = adamw.make_optimizer(base_lr=1e-3, warmup=1, total=10)
    batch = _batch(m.cfg, seq=16, batch=8)
    jstate, jmet = jax.jit(jmake_train_step(jm, jopt, microbatches))(
        JTrainState(jp, jopt.init(jp)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    state, met = make_train_step(m, opt, microbatches)(
        TrainState(p, opt.init(p)), batch)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=LOSS_RTOL, atol=1e-9)
    for a, b in zip(leaves(state.params), jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=2e-5)
    for a, b in zip(leaves(state.opt.m) + leaves(state.opt.v),
                    jax.tree.leaves(jstate.opt.m)
                    + jax.tree.leaves(jstate.opt.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    assert int(state.opt.step) == 1


def test_microbatches_match_the_full_batch():
    """The port's own trade: 4 microbatches update like 1 full batch
    (the reference's ``test_microbatch_accumulation_matches_full_batch``
    bounds)."""
    _, _, m, p = _pair()
    opt = adamw.make_optimizer(base_lr=1e-3, warmup=1, total=10)
    batch = _batch(m.cfg, seq=16, batch=8)
    runs = []
    for mb in (1, 4):
        fresh = tree_map(lambda t: t.detach().clone(), p)
        runs.append(make_train_step(m, opt, mb)(
            TrainState(fresh, opt.init(fresh)), batch))
    (s1, m1), (s4, m4) = runs
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for a, b in zip(leaves(s1.params), leaves(s4.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-5)


def _run(tmp, total, hook=None, ckpt_every=2):
    cfg = get_config(ARCH).reduced()
    m = Model(cfg)
    opt = adamw.make_optimizer(base_lr=1e-3, warmup=2, total=total)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=32)
    lcfg = LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                      ckpt_dir=str(tmp), log_every=1)
    return run_training(make_train_step(m, opt),
                        TrainState(p, opt.init(p)),
                        lambda s: data.batch(s, 4), lcfg, step_hook=hook)


def _final_state(tmp):
    from repro_torch.checkpoint.checkpoint import restore

    cfg = get_config(ARCH).reduced()
    p = Model(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    like = TrainState(p, adamw.adamw_init(p))
    return restore(str(tmp), like)[0]


def test_crash_and_exact_resume(tmp_path):
    """A crash at step 3 saves that step's state; the resumed run ends bit
    for bit where an uninterrupted one does."""
    whole = _run(tmp_path / "whole", 5)
    assert whole.final_step == 5 and whole.resumed_from is None

    def crash(step):
        if step == 3:
            raise RuntimeError("injected crash")

    with pytest.raises(RuntimeError, match="injected"):
        _run(tmp_path / "crash", 5, hook=crash, ckpt_every=100)
    assert latest_step(str(tmp_path / "crash")) == 3
    resumed = _run(tmp_path / "crash", 5, ckpt_every=100)
    assert resumed.resumed_from == 3 and resumed.final_step == 5
    a, b = _final_state(tmp_path / "whole"), _final_state(tmp_path / "crash")
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert [h["loss"] for h in resumed.metrics_history] == \
        [h["loss"] for h in whole.metrics_history[3:]]


def test_exception_inside_the_update_is_not_saved(tmp_path):
    """The optimizer writes the state in place: a failure inside it must
    not reach the crash path's save."""
    _, _, m, p = _pair()
    opt = adamw.make_optimizer()

    class Failing(type(opt)):
        def update(self, grads, state, params):
            raise MemoryError("injected")

    bad = Failing(lr_fn=opt.lr_fn)
    lcfg = LoopConfig(total_steps=3, ckpt_every=1, ckpt_dir=str(tmp_path))
    data = SyntheticTokens(vocab=m.cfg.vocab, seq_len=16)
    with pytest.raises(TornStateError):
        run_training(make_train_step(m, bad), TrainState(p, bad.init(p)),
                     lambda s: data.batch(s, 2), lcfg)
    assert latest_step(str(tmp_path)) is None


def _watchdog_run(package, tmp, slow_from, n_slow):
    """Both loops on a trivial step under one fake clock: steps take 1 s,
    then 10 s from ``slow_from`` for ``n_slow`` steps."""
    clock = {"t": 0.0}

    def hook(step):
        slow = slow_from <= step < slow_from + n_slow
        clock["t"] += 10.0 if slow else 1.0

    if package == "ref":
        state = {"w": jnp.zeros(3)}
        step = lambda s, b: ({"w": s["w"] + 1}, {"loss": jnp.sum(s["w"])})  # noqa: E731
        mod = jloop
    else:
        state = {"w": torch.zeros(3)}
        step = lambda s, b: ({"w": s["w"] + 1}, {"loss": s["w"].sum()})  # noqa: E731
        mod = tloop
    cfg = mod.LoopConfig(total_steps=40, ckpt_every=100, ckpt_dir=str(tmp),
                         log_every=5, slow_factor=3.0,
                         max_consecutive_slow=4, watchdog_warmup=10)
    try:
        res = mod.run_training(step, state, lambda s: None, cfg,
                               step_hook=hook, time_fn=lambda: clock["t"])
        return ("done", res.final_step, res.straggler_events)
    except mod.ElasticRestart as e:
        return ("restart", str(e), latest_step(str(tmp)))


@pytest.mark.parametrize("slow_from,n_slow", [(25, 100), (20, 2)])
def test_watchdog_under_injected_clock_matches_reference(tmp_path, slow_from,
                                                         n_slow):
    """A persistent straggler restarts at the reference's step (after its
    checkpoint); a two-step blip only counts straggler events."""
    want = _watchdog_run("ref", tmp_path / "ref", slow_from, n_slow)
    got = _watchdog_run("port", tmp_path / "port", slow_from, n_slow)
    assert got == want
    assert got[0] == ("restart" if n_slow > 4 else "done")


def _numpy_batches(step):
    r = np.random.default_rng(step)
    return {"tokens": r.integers(0, 100, (2, 8)).astype(np.int32)}


@pytest.mark.parametrize("start", [0, 7])
def test_pipeline_order_close_and_resume_match_reference(start):
    with JDataPipeline(_numpy_batches, start_step=start) as jp, \
            DataPipeline(_numpy_batches, start_step=start) as tp:
        assert tp.depth == jp.depth
        for want_step in range(start, start + 6):
            (js, jb), (ts, tb) = next(jp), next(tp)
            assert ts == js == want_step
            np.testing.assert_array_equal(tb["tokens"], np.asarray(
                jb["tokens"]))
    assert not tp._thread.is_alive()


def test_launcher_trains_resumes_and_takes_model_parallel_on_one_rank(
        tmp_path, monkeypatch):
    """The launcher trains, resumes, and takes ``--model-parallel`` on one
    rank (the mesh is (1, 1)); every step of a one-rank run goes through
    its step program (``core.programs.StepProgram``)."""
    from repro_torch.core import programs
    from repro_torch.launch import train as launch

    steps = []
    call = programs.StepProgram.__call__

    def counted(self, state, batch):
        steps.append(self.name)
        return call(self, state, batch)

    monkeypatch.setattr(programs.StepProgram, "__call__", counted)
    args = ["--arch", ARCH, "--reduced", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    res = launch.main(args)
    assert res.final_step == 4 and res.resumed_from is None
    assert steps == ["train_step"] * 4
    again = launch.main(args[:4] + ["6"] + args[5:])
    assert again.resumed_from == 4 and again.final_step == 6
    # --model-parallel is no longer refused: on one rank the elastic mesh
    # is (1, 1), as the reference's on one device, and the run resumes
    mp = launch.main(args[:4] + ["8"] + args[5:] + ["--model-parallel", "2"])
    assert mp.resumed_from == 6 and mp.final_step == 8
    assert steps == ["train_step"] * 8
    # a MoE config trains too (the loop logs its metrics every 10 steps)
    moe = launch.main(["--arch", "grok-1-314b", "--reduced", "--steps", "10",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "moe")])
    assert moe.final_step == 10
    assert np.isfinite(moe.metrics_history[-1]["loss"])


def test_quantized_model_trains_on_the_cpu():
    """``weight_bits=8``: two steps, finite falling loss; the paths carry
    the reference's ``TrainState`` keys."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), weight_bits=8)
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw.make_optimizer(base_lr=1e-2, warmup=1, total=4)
    step = make_train_step(m, opt)
    state = TrainState(p, opt.init(p))
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=32)
    losses = []
    for i in range(3):
        state, met = step(state, data.batch(0, 4))
        losses.append(float(met["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    keys = [k for k, _ in leaves_with_paths(state)]
    assert "params/blocks/sub0/attn/wq/w" in keys and "opt/step" in keys
