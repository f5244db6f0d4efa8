"""The port's mamba block (``repro_torch.models.ssm``) on the CPU against
the JAX package's ``repro.models.ssm``.

The same numpy-seeded inputs go to both sides, in float32:

  * ``selective_scan_chunked`` (several chunks, with and without a carried
    state ``h0``), ``selective_scan_ref`` and ``selective_scan_step``
    against the reference's three; the chunked scan also against the
    port's own per-step oracle, and ``T % chunk != 0`` raises
    ``ValueError``;
  * ``causal_conv1d`` with and without carried state, and split in two
    segments equal to one call over the whole input;
  * ``ssm_apply`` and ``ssm_decode`` stepped over T tokens (the cache
    updated in place, through views as the layer stack passes them) on
    the reference's ``ssm_init`` weights for reduced jamba and
    falcon-mamba; the last decode state equals the chunked scan's.

Tolerance 1e-4 (``TOL``) unless stated: the port's in-chunk scan sums in
another order than the reference's ``associative_scan``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models.model import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)


def _scan_inputs(seed, B=2, T=48, di=6, st=4, with_h0=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    out = {
        "x": rng.standard_normal((B, T, di)).astype(f),
        "dt": rng.uniform(0.01, 0.5, (B, T, di)).astype(f),
        "B_t": rng.standard_normal((B, T, st)).astype(f),
        "C_t": rng.standard_normal((B, T, st)).astype(f),
        "A": -rng.uniform(0.5, 2.0, (di, st)).astype(f),
        "D": rng.standard_normal(di).astype(f),
    }
    if with_h0:
        out["h0"] = rng.standard_normal((B, di, st)).astype(f)
    return out


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("chunk,with_h0", [(16, False), (16, True),
                                           (8, True), (48, False),
                                           (64, True)])
def test_chunked_scan_matches_reference(chunk, with_h0):
    """T 48 in 3 or 6 chunks, one whole chunk, and a chunk longer than T
    (taken as T); with and without a carried state."""
    inp = _scan_inputs(1, with_h0=with_h0)
    wy, wh = jssm.selective_scan_chunked(**_j(inp), chunk=chunk)
    y, h = ssm.selective_scan_chunked(**_t(inp), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)
    ry, rh = ssm.selective_scan_ref(**_t(inp))
    np.testing.assert_allclose(y.numpy(), ry.numpy(), **TOL)
    np.testing.assert_allclose(h.numpy(), rh.numpy(), **TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_reference_scan_and_step_match_reference(with_h0):
    inp = _scan_inputs(2, T=12, with_h0=with_h0)
    wy, wh = jssm.selective_scan_ref(**_j(inp))
    y, h = ssm.selective_scan_ref(**_t(inp))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **TOL)
    # the decode step, stepped over T from the same state
    th = torch.from_numpy(inp["h0"]) if with_h0 else torch.zeros(2, 6, 4)
    jh = jnp.asarray(th.numpy())
    t = _t(inp)
    for i in range(12):
        args = [t[k][:, i] for k in ("x", "dt", "B_t", "C_t")]
        yi, th = ssm.selective_scan_step(*args, t["A"], t["D"], th)
        wyi, jh = jssm.selective_scan_step(*[jnp.asarray(a.numpy())
                                             for a in args],
                                           jnp.asarray(inp["A"]),
                                           jnp.asarray(inp["D"]), jh)
        np.testing.assert_allclose(yi.numpy(), np.asarray(wyi), **TOL)
        np.testing.assert_allclose(yi.numpy(), y[:, i].numpy(), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_chunked_scan_rejects_a_ragged_sequence():
    t = _t(_scan_inputs(3, T=20))
    with pytest.raises(ValueError, match="not divisible"):
        ssm.selective_scan_chunked(**t, chunk=8)


@pytest.mark.parametrize("K", [1, 4])
def test_causal_conv_carries_state_like_reference(K):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, 5)).astype(np.float32)
    w = rng.standard_normal((K, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    state = rng.standard_normal((2, K - 1, 5)).astype(np.float32)
    for st in (None, state):
        jy, js = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
        y, s = ssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b),
                                 None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # two segments with the state carried equal one call
    y_all, s_all = ssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b))
    y1, s1 = ssm.causal_conv1d(torch.from_numpy(x[:, :4]),
                               torch.from_numpy(w), torch.from_numpy(b))
    y2, s2 = ssm.causal_conv1d(torch.from_numpy(x[:, 4:]),
                               torch.from_numpy(w), torch.from_numpy(b), s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y_all)
    assert torch.equal(s2, s_all)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "falcon-mamba-7b"])
def test_mamba_block_prefill_and_decode_match_reference(name):
    """``ssm_apply`` over T = 48 (3 chunks of 16), then ``ssm_decode``
    stepped over the same 48 tokens from a zeroed cache: every step's
    output equals the reference's, the cache is written in place through
    views of a stacked cache, and the last state equals the reference's."""
    jcfg = jget_config(name).reduced()
    cfg = get_config(name).reduced()
    jp = jssm.ssm_init(jax.random.PRNGKey(5), jcfg)
    p = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       jp), cfg, "cpu")
    x = np.random.default_rng(6).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    want = np.asarray(jssm.ssm_apply(jcfg, jp, jnp.asarray(x)))
    got = ssm.ssm_apply(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    jc = jssm.ssm_cache_init(jcfg, 2)
    stacked = {k: v[None].clone()
               for k, v in ssm.ssm_cache_init(cfg, 2).items()}
    view = {k: v[0] for k, v in stacked.items()}       # as stack_decode
    jdec = jax.jit(lambda p_, x_, c_: jssm.ssm_decode(jcfg, p_, x_, c_))
    for t in range(48):
        wy, jc = jdec(jp, jnp.asarray(x[:, t:t + 1]), jc)
        y, back = ssm.ssm_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]),
                                 view)
        assert back is view
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(y.numpy()[:, 0], got.numpy()[:, t], **TOL)
    for k in ("conv", "h"):
        np.testing.assert_allclose(stacked[k][0].numpy(), np.asarray(jc[k]),
                                   **TOL)
    assert stacked["h"].dtype == torch.float32


def test_ssm_init_matches_reference_structure_and_dtypes():
    """Leaf names, shapes and dtypes of ``ssm_init`` on a bf16 config equal
    the reference's: ``A_log``, ``D`` and ``dt_proj.b`` float32; ``A_log``
    log(1..state) in every row, dt's bias the inverse softplus of
    [1e-3, 1e-1]."""
    jcfg = dataclasses.replace(jget_config("jamba-v0.1-52b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b").reduced(),
                              dtype="bfloat16")
    jshape = jax.eval_shape(lambda k: jssm.ssm_init(k, jcfg),
                            jax.random.PRNGKey(0))
    p = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jshape)
    assert len(jl) == len(jax.tree.leaves(p))
    for path, want in jl:
        got = p
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    np.testing.assert_allclose(
        p["A_log"].numpy(),
        np.log(np.broadcast_to(np.arange(1, cfg.ssm_state + 1),
                               (cfg.d_inner, cfg.ssm_state))), rtol=1e-6)
    dt = torch.nn.functional.softplus(p["dt_proj"]["b"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) <= 1e-1 + 1e-7
