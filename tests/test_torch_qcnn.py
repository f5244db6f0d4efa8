"""The conv exporter (``repro_torch.core.qir.export_qcnn``), the numpy-only
IC / CNV descriptions (``repro_torch.models.tiny``) and the full-width
graphs of ``repro_torch.bench.models`` against the JAX package.

Both exporters get the same numpy parameters (the reference's ``init``
mapped to ``np.asarray``, or the port's ``init_numpy``) and must write the
same QIR JSON: IC at the paper's width with and without calibration (the
calibrated scales compared first), CNV at the paper's width. At a reduced
width the port's compiled codes equal the reference's ``compile_graph``
bit for bit and the logits agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qir as jqir
from repro.deploy import compile_graph as jcompile
from repro.models import tiny as jtiny
from repro_torch.bench import models as bench_models
from repro_torch.core import qir as tqir
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.models import tiny as ttiny

#: (port model, reference model) pairs: the paper's widths, then the
#: reduced widths the compiled-code tests run
FULL = {"ic": (ttiny.ICModel(), jtiny.ICModel()),
        "cnv": (ttiny.CNVModel(), jtiny.CNVModel())}
REDUCED_KW = {"ic": dict(in_hw=8, filters=(4, 4), kernels=(3, 3),
                         strides=(1, 2)),
              "cnv": dict(channels=(4, 4, 8, 8, 8, 8), fc=(16, 16))}
REDUCED = {"ic": (ttiny.ICModel(**REDUCED_KW["ic"]),
                  jtiny.ICModel(**REDUCED_KW["ic"])),
           "cnv": (ttiny.CNVModel(**REDUCED_KW["cnv"]),
                   jtiny.CNVModel(**REDUCED_KW["cnv"]))}
MODELS = [(w, n) for w in ("full", "reduced") for n in ("ic", "cnv")]


def _numpy_params(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), params)


def _pair(width, name):
    return (FULL if width == "full" else REDUCED)[name]


def _calibration(model, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-127, 128, (n, model.in_hw, model.in_hw,
                                    model.in_ch)).astype(np.int32)


def _scales(g):
    return [n.attrs["scale"] for n in g.nodes
            if n.op == "Quant" and "scale" in n.attrs]


def test_cnv_has_the_papers_weight_count():
    assert ttiny.CNVModel().n_weights() == 1_542_848
    assert ttiny.CNVModel().n_weights() == jtiny.CNVModel().n_weights()


@pytest.mark.parametrize("width,name", MODELS)
def test_model_descriptions_equal_reference(width, name):
    """Fields, ``conv_layers()`` (what the exporter reads), ``cost()``
    layer by layer, and ``feature_hw()`` / ``n_weights()``."""
    t, j = _pair(width, name)
    assert type(t).__name__ == type(j).__name__
    jfields = {f: getattr(j, f) for f in j.__dataclass_fields__}
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == jfields
    keys = ("in_ch", "out_ch", "kernel", "stride", "padding", "weight_bits",
            "act_bits")
    assert [tuple(getattr(ld, k) for k in keys) for ld in t.conv_layers()] \
        == [tuple(getattr(ld, k) for k in keys) for ld in j.conv_layers()]
    tc, jc = t.cost(), j.cost()
    assert [vars(layer) for layer in tc.layers] == \
        [vars(layer) for layer in jc.layers]
    assert (tc.bops, tc.wm_bits, tc.flops, tc.n_params) == \
        (jc.bops, jc.wm_bits, jc.flops, jc.n_params)
    if name == "ic":
        assert t.feature_hw() == j.feature_hw()
    else:
        assert t.n_weights() == j.n_weights()


@pytest.mark.parametrize("width,name", MODELS)
def test_init_numpy_has_the_reference_init_structure(width, name):
    """Same tree, shapes and dtypes as the reference's ``init``; weights
    inside the Glorot bound, biases 0; the seed decides the draw."""
    t, j = _pair(width, name)
    want = _numpy_params(j.init(jax.random.PRNGKey(0)))
    got = t.init_numpy(7)
    spec = lambda p: jax.tree_util.tree_map(  # noqa: E731
        lambda a: (a.shape, a.dtype), p)
    assert spec(got) == spec(want)
    for p in jax.tree_util.tree_leaves(got):
        assert np.isfinite(p).all()
    for p in got["convs"]:
        k, _, cin, cout = p["w"].shape
        limit = (6.0 / ((cin + cout) * k * k)) ** 0.5
        assert np.abs(p["w"]).max() <= limit and p["w"].std() > limit / 4
        assert not p["b"].any()
    again = t.init_numpy(7)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(again)))
    other = t.init_numpy(8)
    assert not np.array_equal(other["convs"][0]["w"], got["convs"][0]["w"])


@pytest.mark.parametrize("case", ["ic", "ic_calibrated", "cnv"])
def test_export_qcnn_json_identical_at_full_width(case):
    """The paper's IC (32x32x3, 32-4-32-32-4) with and without calibration
    and CNV-W1A1 from the reference's ``init`` (IC with seeded biases):
    identical JSON; the calibrated scales are compared before the
    graphs."""
    name = case.split("_")[0]
    t, j = FULL[name]
    params = _numpy_params(j.init(jax.random.PRNGKey(19)))
    if name == "ic":
        # nonzero biases, so their snapping and the calibration's bias
        # term are compared too (``init`` gives zeros)
        rng = np.random.default_rng(20)
        params["convs"] = [dict(p, b=rng.uniform(-0.2, 0.2, p["b"].shape)
                                .astype(np.float32)) for p in params["convs"]]
    kw = {}
    if case == "ic_calibrated":
        kw["calibrate"] = _calibration(t, 16, 3)
    want = jqir.export_qcnn(j, params, meta={"seed": 19}, **kw)
    got = tqir.export_qcnn(t, params, meta={"seed": 19}, **kw)
    assert _scales(got) == _scales(want)
    if case == "ic_calibrated":
        uncal = _scales(tqir.export_qcnn(t, params))
        assert _scales(got) != uncal       # calibration moved the scales
    assert got.to_json() == want.to_json()


def test_ic_calibration_accumulators_stay_exact_in_float32():
    """Every operand of the calibration conv is an integer times a power
    of two, so the float32 conv is exact in any summation order while
    each output's accumulator reach (sum |code| * |w_int| plus the snapped
    bias, in grid steps) stays under 2^24. Check that bound layer by layer
    on the full-width calibration data, and that the float32 conv equals
    the float64 one there."""
    model = ttiny.ICModel()
    params = model.init_numpy(5)
    params["convs"] = [dict(p, b=np.random.default_rng(i).uniform(
        -0.05, 0.05, p["b"].shape).astype(np.float32))
        for i, p in enumerate(params["convs"])]
    cal = _calibration(model, 16, 4)
    g = tqir.export_qcnn(model, params, calibrate=cal)
    scales = _scales(g)
    codes = torch.as_tensor(cal, dtype=torch.float64)
    scale = 1.0 / 128.0
    for i, ld in enumerate(model.conv_layers()):
        w_hat = g.initializers[f"cw{i}"]
        s_w = g.initializers[f"cws{i}"]
        b_q = g.initializers[f"cb{i}"]
        w_int = np.rint(w_hat / s_w).astype(np.float64)
        assert np.array_equal(w_int * s_w, w_hat)
        bias_steps = np.abs(b_q / (s_w * scale))
        assert np.array_equal(bias_steps, np.rint(bias_steps))
        reach = tqir.conv2d_nhwc(codes.abs(), torch.as_tensor(np.abs(w_int)),
                                 ld.stride, ld.padding)
        steps = float(reach.amax()) + float(bias_steps.max())
        assert steps < 2 ** 24, (i, steps)
        x32 = (codes * scale).to(torch.float32)
        y32 = tqir.conv2d_nhwc(x32, torch.as_tensor(w_hat), ld.stride,
                               ld.padding)
        y64 = tqir.conv2d_nhwc(x32.double(), torch.as_tensor(w_hat).double(),
                               ld.stride, ld.padding)
        assert torch.equal(y32.double(), y64)
        # the next layer's input codes, as the exporter forms them
        r = torch.clamp(y64 + torch.as_tensor(b_q).double(), min=0)
        codes = torch.clamp(torch.floor(r / scales[i] + 0.5), 0,
                            2 ** ld.act_bits - 1)
        scale = scales[i]
    # the paper's worst case itself sits just under the bound
    assert 4 * 4 * 32 * 255 * 127 < 2 ** 24


@pytest.mark.parametrize("name", ["ic", "cnv"])
@pytest.mark.parametrize("mode", ["staged", "auto"])
def test_compiled_codes_equal_reference_at_reduced_width(name, mode):
    """Reduced-width IC and CNV exported by the port from the reference's
    parameters, compiled on the CPU in both dispatch modes: every stage's
    codes equal the reference's ``compile_graph`` bit for bit, the logits
    agree within 1e-5."""
    t, j = REDUCED[name]
    params = _numpy_params(j.init(jax.random.PRNGKey(23)))
    kw = {"calibrate": _calibration(t, 8, 6)} if name == "ic" else {}
    tg = tqir.export_qcnn(t, params, **kw)
    jg = jqir.export_qcnn(j, params, **kw)
    assert tg.to_json() == jg.to_json()
    scale = tg.meta["in_scale"]
    x = _calibration(t, 12, 8)
    cm = tcompile(tg, in_scale=scale, device="cpu",
                  megakernel=False if mode == "staged" else None)
    jm = jcompile(jg, in_scale=scale, use_pallas=False, megakernel=False)
    xj = jnp.asarray(x)
    for i, (got, want) in enumerate(zip(cm.stage_outputs(x),
                                        jm.stage_outputs(xj))):
        want = np.asarray(want)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(i))
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
    np.testing.assert_allclose(cm.offline(x).numpy(),
                               np.asarray(jm.offline(xj)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(cm.predict(x).numpy(),
                                  np.asarray(jm.predict(xj)))


@pytest.mark.parametrize("name", ["ic", "cnv"])
def test_bench_graphs_are_the_exporters_on_init_numpy(name):
    """``ic_graph`` / ``cnv_graph`` are the reference exporter's graphs on
    ``init_numpy``'s parameters (IC calibrated on its seeded codes)."""
    seed = 31
    t, j = FULL[name]
    params = t.init_numpy(seed)
    if name == "ic":
        got = bench_models.ic_graph(seed)
        cal = np.random.default_rng(seed + 1).integers(
            -127, 128, (bench_models.IC_CALIBRATION_SAMPLES, 32, 32, 3),
            dtype=np.int32)
        want = jqir.export_qcnn(j, params,
                                in_scale=bench_models.IC_IN_SCALE,
                                calibrate=cal)
    else:
        got = bench_models.cnv_graph(seed)
        want = jqir.export_qcnn(j, params)
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("name", ["ic", "cnv"])
def test_full_width_graphs_put_nonzero_codes_in_every_stage(name):
    """On seeded input codes every integer stage of the full-width graphs
    holds nonzero codes, so the card does real work; IC's calibration is
    what keeps its deep stages off zero."""
    g = (bench_models.ic_graph(2025) if name == "ic"
         else bench_models.cnv_graph(2026))
    x = np.random.default_rng(9).integers(
        -127, 128, (4, 32, 32, 3)).astype(np.int32)
    cm = tcompile(g, in_scale=g.meta["in_scale"], device="cpu")
    outs = cm.stage_outputs(x)
    shares = [float((o > 0).float().mean()) for o in outs[:-1]]
    assert all(not o.dtype.is_floating_point for o in outs[:-1])
    assert min(shares) > 0.05, shares
    assert torch.isfinite(outs[-1]).all() and outs[-1].shape == (4, 10)
    if name == "ic":
        raw = bench_models.ic_graph(2025, calibrate=False)
        cm0 = tcompile(raw, in_scale=raw.meta["in_scale"], device="cpu")
        raw_shares = [float((o > 0).float().mean())
                      for o in cm0.stage_outputs(x)[:-1]]
        assert sum(raw_shares) < sum(shares)
        assert min(raw_shares) < min(shares)


def test_export_qcnn_rejects_a_model_without_convs():
    with pytest.raises(TypeError, match="no QIR conv exporter"):
        tqir.export_qcnn(tqir.LayerBits(), {})
