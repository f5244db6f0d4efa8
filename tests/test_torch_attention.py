"""The port's attention on the CPU against the JAX package.

  * K6's plain version (``repro_torch.kernels.ops.flash_attention`` on CPU
    tensors) against the reference's Pallas kernel in interpret mode
    (``repro.kernels.ops.flash_attention``) and its jnp oracle, over the
    cases of ``tests/test_kernels.py``: GQA, causal and not, windows, a
    query offset, ragged lengths and ``kv_len``;
  * ``chunked_attention`` (which calls the K6 wrapper), ``naive_attention``,
    ``decode_attention``, ``_decode_ring``, ``mask_bias`` and RoPE against
    their JAX counterparts in ``repro.models.attention``.

The same numpy inputs go to both sides. float32 throughout (the
reference's ``chunked_attention`` rounds scores to the input dtype, K6
does not, so bf16 is held kernel against plain version on the card), and
within 3e-5: float32 sums taken in other orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=3e-5, atol=3e-5)


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _qkv(seed, b, h, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, h, sq, d)), _normal(rng, (b, hkv, sk, d)),
            _normal(rng, (b, hkv, sk, d)))


def _port(q, k, v, **kw):
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    return out.numpy()


# ---------------------------------------------------------------------------
# K6's plain version against the Pallas kernel (interpret) and its oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("sq,sk", [(64, 64), (65, 65), (32, 96)])
def test_flash_plain_matches_pallas_causal_gqa(h, hkv, sq, sk):
    q, k, v = _qkv(h * 100 + sq + sk, 2, h, hkv, sq, sk, 16)
    want = np.asarray(jops.flash_attention(q, k, v, causal=True, block_q=32,
                                           block_k=32, interpret=True))
    oracle = np.asarray(jops.flash_attention_ref(q, k, v, causal=True))
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 16),
                                           (True, 33), (False, 20)])
def test_flash_plain_matches_pallas_masks(causal, window):
    q, k, v = _qkv(window + 7, 1, 2, 2, 96, 96, 16)
    want = np.asarray(jops.flash_attention(q, k, v, causal=causal,
                                           window=window, block_q=32,
                                           block_k=32, interpret=True))
    oracle = np.asarray(jops.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
    got = _port(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_flash_plain_q_offset_decode_chunk(window):
    """Continuation chunk: q holds positions [32, 48) of a 48-long stream,
    and equals the tail of the full attention."""
    q_all, k, v = _qkv(48 + window, 1, 4, 2, 48, 48, 16)
    full = np.asarray(jops.flash_attention_ref(q_all, k, v, causal=True,
                                               window=window))
    tail_q = np.ascontiguousarray(q_all[:, :, 32:])
    want = np.asarray(jops.flash_attention(tail_q, k, v, causal=True,
                                           window=window, q_offset=32,
                                           block_q=16, block_k=16,
                                           interpret=True))
    got = _port(tail_q, k, v, causal=True, window=window, q_offset=32)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, full[:, :, 32:], **TOL)


@pytest.mark.parametrize("causal,kv_len", [(True, 50), (False, 37)])
def test_flash_plain_kv_len_matches_pallas_kernel(causal, kv_len):
    """Keys at or beyond kv_len are masked exactly, as in the Pallas
    kernel's own kv_len path (its wrapper pads Sk and passes the true
    length)."""
    q, k, v = _qkv(kv_len, 1, 4, 2, 64, 64, 16)
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_len=kv_len, block_q=32, block_k=32, interpret=True))
    got = _port(q, k, v, causal=causal, kv_len=kv_len)
    np.testing.assert_allclose(got, want, **TOL)
    cut = np.asarray(jops.flash_attention_ref(
        q, np.ascontiguousarray(k[:, :, :kv_len]),
        np.ascontiguousarray(v[:, :, :kv_len]), causal=causal))
    np.testing.assert_allclose(got, cut, **TOL)


@pytest.mark.parametrize("d", [80, 128])
def test_flash_plain_full_head_dims(d):
    """The head dims of h2o-danube (80) and llama3 (128), GQA 4/1."""
    q, k, v = _qkv(d, 1, 4, 1, 40, 40, d)
    want = np.asarray(jops.flash_attention(q, k, v, causal=True, block_q=32,
                                           block_k=32, interpret=True))
    np.testing.assert_allclose(_port(q, k, v, causal=True), want, **TOL)


def test_flash_plain_bf16_matches_oracle():
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, (1, 2, 64, 32)) for _ in range(3))
    want = np.asarray(jops.flash_attention_ref(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=True), np.float32)
    got = ops.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_flash_plain_row_without_live_key_is_zero():
    """A window that ends before kv_len for the last query rows leaves
    them no live key: they give 0 (kernel and plain version alike); every
    other row equals the oracle on the live keys."""
    q, k, v = _qkv(11, 1, 2, 2, 8, 32, 16)
    got = _port(q, k, v, causal=True, window=5, q_offset=20, kv_len=18)
    # row i sits at 20 + i; its live keys are (15 + i, 20 + i] below 18
    assert np.all(got[:, :, 2:] == 0)
    cut = np.asarray(jops.flash_attention_ref(
        q[:, :, :2], np.ascontiguousarray(k[:, :, :18]),
        np.ascontiguousarray(v[:, :, :18]), causal=True, window=5,
        q_offset=20))
    np.testing.assert_allclose(got[:, :, :2], cut, **TOL)


def _bf16_kernel_numerics(q, k, v, *, causal, window, q_offset, kv_len,
                          block_k=128, round_p=True):
    """K6's bf16 kernel (``csrc/flash_attention.cu``) in plain tensor ops:
    scores and statistics in float32, 128-key tiles in order with the
    online softmax, P rounded to bf16 before P.V (the tensor cores' A
    operand), l summed from the unrounded P, the output rounded to bf16;
    a row without a live key gives 0. ``round_p=False`` keeps P and the
    output in float32: then it is plain tiled flash attention."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    kk = k.float().repeat_interleave(h // hkv, dim=1)
    vv = v.float().repeat_interleave(h // hkv, dim=1)
    s_all = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * d ** -0.5
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(sk)[None, :]
    live = kpos < kv_len
    if causal:
        live = live & (kpos <= qpos)
    if window > 0:
        live = live & (kpos > qpos - window)
    s_all = torch.where(live, s_all, -torch.inf)
    m = torch.full((b, h, sq, 1), -torch.inf)
    l = torch.zeros((b, h, sq, 1))
    o = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, block_k):
        s = s_all[..., k0:k0 + block_k]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        corr = torch.exp(m - m_use)
        p = torch.exp(s - m_use)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        p16 = p.to(torch.bfloat16).float() if round_p else p
        o = o * corr + torch.einsum("bhqk,bhkd->bhqd", p16,
                                    vv[:, :, k0:k0 + block_k])
        m = m_new
    inv = torch.where(l > 0, 1.0 / l.clamp_min(1e-30), 0.0)
    return (o * inv).to(torch.bfloat16 if round_p else torch.float32)


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window,q_offset,kv_len", [
    (2, 4, 2, 130, 130, 16, False, 0, 0, None),
    (1, 4, 2, 257, 257, 80, True, 32, 0, None),
    (2, 4, 2, 17, 95, 128, True, 0, 78, None),
    (1, 4, 2, 70, 133, 80, False, 0, 0, 101),
    (2, 4, 2, 65, 200, 16, True, 32, 120, 150),
    (1, 4, 2, 255, 255, 128, True, 100, 0, None),
    (1, 8, 2, 127, 255, 128, True, 0, 128, None)])
def test_flash_bf16_kernel_numerics_within_the_tolerance(
        b, h, hkv, sq, sk, d, causal, window, q_offset, kv_len):
    """The bf16 kernel rounds P to bf16 before P.V, the plain version does
    not: on seeded inputs the emulated kernel stays within the 2e-2 that
    the card holds K6 to against the plain version (bf16 outputs of
    O(1))."""
    rng = np.random.default_rng(sq * 3 + sk + d)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in (
        _normal(rng, (b, h, sq, d)), _normal(rng, (b, hkv, sk, d)),
        _normal(rng, (b, hkv, sk, d))))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    got = _bf16_kernel_numerics(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, **kw)         # the plain version
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    # without the roundings the emulation is the float32 plain version
    exact = _bf16_kernel_numerics(q.float(), k.float(), v.float(),
                                  round_p=False, **kw)
    torch.testing.assert_close(
        exact, ops.flash_attention(q.float(), k.float(), v.float(), **kw),
        **TOL)


def test_flash_wrapper_checks_arguments():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)                 # Hkv does not divide H
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 4, 2, 8, 8, 16))
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, kv_len=9)
    before = dict(ops.launches)
    ops.flash_attention(q, k, v)
    assert ops.launches == before                    # plain versions: no count


# ---------------------------------------------------------------------------
# the model's attention functions against repro.models.attention
# ---------------------------------------------------------------------------

CONFIGS = ["llama3-8b", "h2o-danube-1.8b"]


def _cfgs(name):
    return jget_config(name).reduced(), get_config(name).reduced()


def _bshd(seed, cfg, b, s, heads):
    return _normal(np.random.default_rng(seed), (b, s, heads, cfg.hd))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("s", [64, 96])
def test_chunked_attention_matches_reference(name, s):
    jcfg, cfg = _cfgs(name)
    q = _bshd(s, cfg, 2, s, cfg.n_heads)
    k = _bshd(s + 1, cfg, 2, s, cfg.n_kv_heads)
    v = _bshd(s + 2, cfg, 2, s, cfg.n_kv_heads)
    pos = np.arange(s, dtype=np.int32)
    want = np.asarray(jattn.chunked_attention(jcfg, q, k, v, pos, pos))
    tpos = torch.from_numpy(pos)
    got = tattn.chunked_attention(cfg, torch.from_numpy(q),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  tpos, tpos)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    naive = np.asarray(jattn.naive_attention(
        q, k, v, jattn.mask_bias(jcfg, pos, pos)))
    np.testing.assert_allclose(got.numpy(), naive, **TOL)


def test_chunked_attention_rejects_non_arange_positions():
    _, cfg = _cfgs("llama3-8b")
    q = torch.from_numpy(_bshd(0, cfg, 1, 8, cfg.n_heads))
    k = torch.from_numpy(_bshd(1, cfg, 1, 8, cfg.n_kv_heads))
    pos = torch.arange(8)
    with pytest.raises(ValueError):
        tattn.chunked_attention(cfg, q, k, k, pos.flip(0), pos)
    with pytest.raises(ValueError):
        tattn.chunked_attention(cfg, q, k, k, pos, pos + 1)


@pytest.mark.parametrize("name", CONFIGS)
def test_naive_attention_and_mask_bias_match_reference(name):
    jcfg, cfg = _cfgs(name)
    q = _bshd(5, cfg, 2, 48, cfg.n_heads)
    k = _bshd(6, cfg, 2, 48, cfg.n_kv_heads)
    v = _bshd(7, cfg, 2, 48, cfg.n_kv_heads)
    pos = np.arange(48, dtype=np.int32)
    jbias = np.asarray(jattn.mask_bias(jcfg, pos, pos))
    tpos = torch.from_numpy(pos)
    tbias = tattn.mask_bias(cfg, tpos, tpos)
    np.testing.assert_array_equal(tbias.numpy(), jbias)
    want = np.asarray(jattn.naive_attention(q, k, v, jbias))
    got = tattn.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tbias)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", CONFIGS)
def test_rope_matches_reference(name):
    jcfg, cfg = _cfgs(name)
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    x = _bshd(9, cfg, 2, 20, cfg.n_heads)
    jc, js = jattn.positions_cos_sin(jcfg, pos)
    tc, ts = tattn.positions_cos_sin(cfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    want = np.asarray(jattn.apply_rope(x, jc, js))
    got = tattn.apply_rope(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("cur", [5, "per-slot"])
def test_decode_attention_matches_reference(name, cur):
    jcfg, cfg = _cfgs(name)
    S = 40
    q = _bshd(11, cfg, 3, 1, cfg.n_heads)
    kc = _bshd(12, cfg, 3, S, cfg.n_kv_heads)
    vc = _bshd(13, cfg, 3, S, cfg.n_kv_heads)
    cur_np = (np.asarray([1, 17, 40], np.int32) if cur == "per-slot"
              else np.int32(cur))
    want = np.asarray(jattn.decode_attention(jcfg, q, kc, vc,
                                             jnp.asarray(cur_np)))
    got = tattn.decode_attention(cfg, torch.from_numpy(q),
                                 torch.from_numpy(kc), torch.from_numpy(vc),
                                 torch.as_tensor(cur_np))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_ring_matches_reference():
    jcfg, cfg = _cfgs("h2o-danube-1.8b")
    S = cfg.window
    q = _bshd(21, cfg, 3, 1, cfg.n_heads)
    kc = _bshd(22, cfg, 3, S, cfg.n_kv_heads)
    vc = _bshd(23, cfg, 3, S, cfg.n_kv_heads)
    n_valid = np.asarray([1, 9, S], np.int32)[:, None, None, None]
    want = np.asarray(jattn._decode_ring(jcfg, q, kc, vc, n_valid))
    got = tattn._decode_ring(cfg, torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(n_valid))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_attn_apply_dispatch_follows_attn_impl(monkeypatch):
    """"chunked" runs the K6 wrapper, "naive" does not, "auto" picks
    chunked only above 2048 positions; all three agree."""
    _, cfg = _cfgs("llama3-8b")
    calls = []
    real = ops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    g = torch.Generator().manual_seed(0)
    p = tattn.attn_init(g, cfg, device="cpu")
    xs = {s: torch.randn(1, s, cfg.d_model, generator=g) for s in (16, 2049)}
    outs = {}
    for impl, s in (("chunked", 16), ("naive", 16), ("auto", 16),
                    ("auto", 2049)):
        c = dataclasses.replace(cfg, attn_impl=impl)
        x, pos = xs[s], torch.arange(s)[None]
        calls.clear()
        out = tattn.attn_apply(c, p, x, pos)
        assert len(calls) == (impl == "chunked" or s > 2048), (impl, s)
        if s == 16:
            outs[impl] = out
    torch.testing.assert_close(outs["chunked"], outs["naive"], **TOL)
    torch.testing.assert_close(outs["auto"], outs["naive"], **TOL)
