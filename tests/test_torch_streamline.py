"""Quantizers and streamlining in the port against the JAX package.

Banks and scales are built in float32 with the reference's operation
order, so every comparison here is exact: integer weights, threshold
banks (including the saturating float -> int32 cast of an all-zero weight
column) and output scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as jq
from repro.core import streamline as js
from repro_torch.core import quantizers as tq
from repro_torch.core import streamline as ts
from _torch_threads import one_torch_thread  # noqa: F401


def _dense_params(rng, fan_in, fan_out, bn=True, zero_col=None):
    p = {"w": (rng.standard_normal((fan_in, fan_out))
               * np.sqrt(2.0 / fan_in)).astype(np.float32),
         "b": (0.1 * rng.standard_normal(fan_out)).astype(np.float32)}
    if bn:
        p.update(gamma=rng.uniform(0.5, 1.5, fan_out).astype(np.float32),
                 beta=(0.1 * rng.standard_normal(fan_out)).astype(np.float32),
                 mu=(0.2 * rng.standard_normal(fan_out)).astype(np.float32),
                 sigma2=rng.uniform(0.5, 2.0, fan_out).astype(np.float32))
    if zero_col is not None:
        p["w"][:, zero_col] = 0.0
    return p


def _assert_stage_equal(jst, tst):
    np.testing.assert_array_equal(np.asarray(jst.w_int), tst.w_int.numpy())
    assert tst.w_int.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jst.thresholds),
                                  tst.thresholds.numpy())
    assert tst.thresholds.dtype == torch.int32
    assert jst.out_scale == tst.out_scale
    assert jst.act_bits == tst.act_bits
    assert jst.weight_bits == tst.weight_bits


@pytest.mark.parametrize("scale", [1e-30, 3e-4, 0.007874015748031496, 0.75,
                                   1.5, 3.0, 1e30])
def test_quantize_po2_matches(scale):
    assert float(tq.quantize_po2(scale)) == float(jq.quantize_po2(scale))


@pytest.mark.parametrize("bits,signed,narrow,axis", [(3, True, True, 0),
                                                     (8, True, True, 0),
                                                     (8, False, False, None),
                                                     (4, True, False, None)])
def test_int_quantizer_matches(bits, signed, narrow, axis):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((17, 9)).astype(np.float32)
    x[:, 2] = 0.0
    jqz = jq.IntQuantizer(bits=bits, signed=signed, narrow=narrow, axis=axis)
    tqz = tq.IntQuantizer(bits=bits, signed=signed, narrow=narrow, axis=axis)
    np.testing.assert_array_equal(np.asarray(jqz(jnp.asarray(x))),
                                  tqz(torch.from_numpy(x)).numpy())
    jw, js_ = jqz.quantize_int(jnp.asarray(x))
    tw, ts_ = tqz.quantize_int(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(np.asarray(js_), ts_.numpy())


@pytest.mark.parametrize("bits,bn,zero_col,in_qmax", [
    (3, True, None, None), (8, True, 4, None), (8, False, 0, 255),
    (3, False, 2, 127)])
def test_streamline_dense_bit_equal(bits, bn, zero_col, in_qmax):
    rng = np.random.default_rng(bits * 7 + (zero_col or 0))
    p = _dense_params(rng, 40, 12, bn=bn, zero_col=zero_col)
    kw = dict(weight_bits=bits, act_bits=bits, in_scale=1.0 / 127.0,
              in_qmax=in_qmax)
    jst = js.streamline_dense({k: jnp.asarray(v) for k, v in p.items()}, **kw)
    tst = ts.streamline_dense({k: torch.from_numpy(v) for k, v in p.items()},
                              **kw)
    _assert_stage_equal(jst, tst)
    if zero_col is not None:
        # the all-zero column's bank leaves the int32 range: JAX saturates
        assert int(tst.thresholds[zero_col].max()) == 2 ** 31 - 1


def test_saturating_bank_cast_matches_jax():
    t = np.array([1e10, -1e10, 3e9, np.inf, -np.inf, np.nan, 2.5e9, -7.0],
                 np.float32)
    want = np.asarray(jnp.asarray(t).astype(jnp.int32))
    np.testing.assert_array_equal(
        ts._saturating_int32(torch.from_numpy(t)).numpy(), want)


@pytest.mark.parametrize("bipolar", [False, True])
def test_make_threshold_stage_bit_equal(bipolar):
    rng = np.random.default_rng(11)
    w_int = rng.integers(-7, 8, (30, 6)).astype(np.float32)
    w_int[:, 1] = 0
    s_w = (2.0 ** rng.integers(-8, -2, 6)).astype(np.float32)
    s_w[3] = 1e-8 / 7
    b = (0.05 * rng.standard_normal(6)).astype(np.float32)
    kw = dict(in_scale=0.0078125, act_bits=4, bipolar=bipolar,
              weight_bits=4)
    jst = js.make_threshold_stage(jnp.asarray(w_int), s_w, b, **kw)
    tst = ts.make_threshold_stage(torch.from_numpy(w_int), s_w, b, **kw)
    _assert_stage_equal(jst, tst)


@pytest.mark.parametrize("bn,bipolar", [(True, False), (False, False),
                                        (False, True)])
def test_streamline_conv_bit_equal(bn, bipolar):
    rng = np.random.default_rng(5)
    p = {"w": (0.3 * rng.standard_normal((3, 3, 4, 6))).astype(np.float32),
         "b": (0.1 * rng.standard_normal(6)).astype(np.float32)}
    p["w"][..., 5] = 0.0
    if bn:
        p.update(gamma=rng.uniform(0.5, 1.5, 6).astype(np.float32),
                 beta=(0.1 * rng.standard_normal(6)).astype(np.float32),
                 mu=(0.2 * rng.standard_normal(6)).astype(np.float32),
                 sigma2=rng.uniform(0.5, 2.0, 6).astype(np.float32))
    kw = dict(weight_bits=8, act_bits=8, in_scale=0.0078125, in_qmax=127,
              bipolar=bipolar)
    jst = js.streamline_conv({k: jnp.asarray(v) for k, v in p.items()}, **kw)
    tst = ts.streamline_conv({k: torch.from_numpy(v) for k, v in p.items()},
                             **kw)
    _assert_stage_equal(jst, tst)


@pytest.mark.parametrize("s", [1, 3, 7, 255])
def test_multi_threshold_sorted_equals_linear_count(s):
    rng = np.random.default_rng(s)
    acc = rng.integers(-50, 50, (4, 5, 6)).astype(np.int32)
    t = np.sort(rng.integers(-40, 40, (6, s)), axis=1).astype(np.int32)
    if s > 1:
        t[:, s // 2] = t[:, s // 2 - 1]            # duplicate thresholds
    acc[0, 0] = t[:, 0]                            # exact ties
    a, tt = torch.from_numpy(acc), torch.from_numpy(t)
    lin = ts.multi_threshold(a, tt)
    np.testing.assert_array_equal(ts.multi_threshold_sorted(a, tt).numpy(),
                                  lin.numpy())
    np.testing.assert_array_equal(
        lin.numpy(), np.asarray(js.multi_threshold(jnp.asarray(acc),
                                                   jnp.asarray(t))))


def test_float_ref_dense_and_apply_threshold_dense_match():
    rng = np.random.default_rng(2)
    p = _dense_params(rng, 24, 10)
    x = (rng.integers(-127, 128, (5, 24)) / 127.0).astype(np.float32)
    kw = dict(weight_bits=3, act_bits=3, s_out=0.125)
    want = js.float_ref_dense({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), **kw)
    got = ts.float_ref_dense({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    jst = js.streamline_dense({k: jnp.asarray(v) for k, v in p.items()},
                              weight_bits=3, act_bits=3, in_scale=1 / 127)
    tst = ts.streamline_dense({k: torch.from_numpy(v) for k, v in p.items()},
                              weight_bits=3, act_bits=3, in_scale=1 / 127)
    xi = rng.integers(-127, 128, (5, 24)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(js.apply_threshold_dense(jst, jnp.asarray(xi))),
        ts.apply_threshold_dense(tst, torch.from_numpy(xi)).numpy())


def test_choose_act_scale_matches():
    rng = np.random.default_rng(9)
    k = rng.standard_normal((50, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    for bits, in_qmax in ((3, None), (8, 127), (8, 255), (1, None)):
        kw = dict(in_scale=0.0078125, act_bits=bits, in_qmax=in_qmax)
        assert ts.choose_act_scale(torch.from_numpy(k), torch.from_numpy(b),
                                   **kw) == \
            js.choose_act_scale(jnp.asarray(k), jnp.asarray(b), **kw)
