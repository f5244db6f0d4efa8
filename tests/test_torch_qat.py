"""The port's QAT half against the JAX package: the straight-through
quantizers (``core.quantizers``), the quantized layers (``core.qlayers``),
the four tiny models' forward (``models.tiny``), ``train_tiny`` and
``bitwidth_descent`` (``core.codesign``).

Both sides get the same numpy inputs and the reference's ``init``
parameters (``from_numpy``). Tolerances:
  * STE forward and gradients, quantizer outputs: exact;
  * float layer outputs: rtol = atol = 1e-5;
  * quantized activations: equal, except where float reordering moves a
    value across a rounding boundary; such elements differ by exactly one
    step and are at most 0.1% of them (``assert_codes_close``);
  * ``train_tiny``: parameters after one step within 1e-5, the losses of
    five steps within 1e-3 relative;
  * ``bitwidth_descent``: equal.
Pinned: the reference's CNV forward with 1-bit conv weights gives NaN
weights, so its logits do not depend on the input and its conv-weight
gradients are NaN (the port reproduces it); ``mu`` / ``sigma2`` are trained
in both; the train-mode BN statistics equal the reference's new params.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codesign as jcodesign
from repro.core import qlayers as jql
from repro.core import quantizers as jq
from repro.models import tiny as jtiny
from repro_torch.core import codesign as tcodesign
from repro_torch.core import qlayers as tql
from repro_torch.core import quantizers as tq
from repro_torch.models import tiny as ttiny


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _rng(seed):
    return np.random.default_rng(seed)


def assert_codes_close(got, want, step, frac=1e-3):
    """Quantized values (code x scale) equal within the float tolerance
    (rtol = atol = 1e-5: the scale itself is a float reduction), but for
    elements moved across a rounding boundary: those differ by one
    ``step`` and are at most ``frac`` of all elements."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    off = diff > 1e-5 + 1e-5 * np.abs(want)
    np.testing.assert_allclose(diff[off], step, rtol=1e-5)
    assert off.sum() <= int(frac * got.size), (off.sum(), got.size)


# ---------------------------------------------------------------------------
# straight-through primitives
# ---------------------------------------------------------------------------

def _ste_inputs():
    r = _rng(0)
    x = r.uniform(-3, 3, 257).astype(np.float32)
    # exact halves (round-half-even), the clip and sign edges
    edges = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, -1.0, 1.0, 0.0,
                      -0.0, 2.0, -2.0, 1.0000001, -1.0000001], np.float32)
    return np.concatenate([x, edges])


STE = {
    "round": (lambda x: jq.ste_round(x), lambda x: tq.ste_round(x)),
    "clip": (lambda x: jq.ste_clip(x, -1.0, 2.0),
             lambda x: tq.ste_clip(x, -1.0, 2.0)),
    "sign": (lambda x: jq.ste_sign(x), lambda x: tq.ste_sign(x)),
}


@pytest.mark.parametrize("name", sorted(STE))
def test_ste_forward_and_gradient_are_exact(name):
    jf, tf = STE[name]
    x = _ste_inputs()
    g = _rng(1).standard_normal(x.shape).astype(np.float32)
    jy, jvjp = jax.vjp(jf, jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ty = tf(tx)
    ty.backward(torch.tensor(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


QUANTIZERS = {
    "int8": dict(bits=8),
    "int3_axis0_narrow": dict(bits=3, axis=0, narrow=True),
    "uint4": dict(bits=4, signed=False),
    "int6_po2": dict(bits=6, po2=True),
    "int1_narrow": dict(bits=1, narrow=True),      # qmax 0: NaN, as the ref
}


@pytest.mark.parametrize("name", sorted(QUANTIZERS))
def test_int_quantizer_output_and_gradient_are_exact(name):
    kw = QUANTIZERS[name]
    x = _rng(2).standard_normal((33, 7)).astype(np.float32)
    g = _rng(3).standard_normal(x.shape).astype(np.float32)
    jquant, tquant = jq.IntQuantizer(**kw), tq.IntQuantizer(**kw)
    jy, jvjp = jax.vjp(jquant, jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ty = tquant(tx)
    ty.backward(torch.tensor(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("kind", ["fixed", "binary", "ternary", "act8",
                                  "act4", "act16"])
def test_other_quantizers_are_exact(kind):
    x = (_rng(4).standard_normal((41, 5)) * 2).astype(np.float32)
    g = _rng(5).standard_normal(x.shape).astype(np.float32)
    if kind == "fixed":
        jf, tf = jq.FixedPointQuantizer(8, 2), tq.FixedPointQuantizer(8, 2)
        np.testing.assert_array_equal(
            tf.int_repr(torch.tensor(x)).numpy(),
            np.asarray(jf.int_repr(jnp.asarray(x))))
    elif kind == "binary":
        jf, tf = jq.BinaryQuantizer(), tq.BinaryQuantizer()
    elif kind == "ternary":
        jf, tf = jq.TernaryQuantizer(), tq.TernaryQuantizer()
    else:
        bits = int(kind[3:])
        jf = lambda v: jq.fake_quant_act(v, bits)  # noqa: E731
        tf = lambda v: tq.fake_quant_act(v, bits)  # noqa: E731
    jy, jvjp = jax.vjp(jf, jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ty = tf(tx)
    ty.backward(torch.tensor(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("bits,kind", [(32, "int"), (8, "none"), (1, "int"),
                                       (4, "binary"), (2, "ternary"),
                                       (8, "fixed"), (5, "int")])
def test_make_quantizer_picks_the_same_kind(bits, kind):
    j, t = jq.make_quantizer(bits, kind), tq.make_quantizer(bits, kind)
    assert (j is None) == (t is None)
    if j is not None:
        assert type(j).__name__ == type(t).__name__
        assert j.bits == t.bits


# ---------------------------------------------------------------------------
# quantized layers
# ---------------------------------------------------------------------------

def _dense_pair(cls, din, dout, seed, **kw):
    jl = getattr(jql, cls)(din, dout, **kw)
    p = _np(jl.init(jax.random.PRNGKey(seed)))
    if cls == "QDenseBatchNorm":
        r = _rng(seed)
        p["gamma"] = r.uniform(0.5, 1.5, dout).astype(np.float32)
        p["beta"] = (0.1 * r.standard_normal(dout)).astype(np.float32)
        p["mu"] = (0.1 * r.standard_normal(dout)).astype(np.float32)
        p["sigma2"] = r.uniform(0.5, 2.0, dout).astype(np.float32)
        p["b"] = (0.1 * r.standard_normal(dout)).astype(np.float32)
    tl = getattr(tql, cls)(din, dout, **kw).from_numpy(p)
    return jl, tl, p


def test_layer_parameters_round_trip_and_keep_the_reference_names():
    jl, tl, p = _dense_pair("QDenseBatchNorm", 12, 5, 0)
    out = tl.to_numpy()
    assert sorted(out) == sorted(p) == ["b", "beta", "gamma", "mu", "sigma2",
                                        "w"]
    for k in p:
        np.testing.assert_array_equal(out[k], p[k])
    # mu and sigma2 are trained: parameters, not buffers
    names = dict(tl.named_parameters())
    assert names["mu"].requires_grad and names["sigma2"].requires_grad
    assert not list(tl.buffers())


def test_init_draws_glorot_ranges_from_a_generator():
    a = tql.QDense(30, 10, generator=torch.Generator().manual_seed(3))
    b = tql.QDense(30, 10, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)
    limit = (6.0 / 40) ** 0.5
    assert float(a.w.detach().abs().max()) <= limit
    assert float(a.b.detach().abs().max()) == 0
    c = tql.QConv2D(3, 8, kernel=3, generator=torch.Generator().manual_seed(4))
    assert tuple(c.w.shape) == (3, 3, 3, 8)
    assert float(c.w.detach().abs().max()) <= (6.0 / (27 + 72)) ** 0.5


@pytest.mark.parametrize("relu,act_bits,weight_bits", [
    (False, 32, 32), (True, 32, 8), (True, 4, 3), (False, 8, 8)])
def test_qdense_matches_reference(relu, act_bits, weight_bits):
    jl, tl, p = _dense_pair("QDense", 24, 16, 7, relu=relu,
                            act_bits=act_bits, weight_bits=weight_bits)
    x = _rng(8).standard_normal((64, 24)).astype(np.float32)
    want = np.asarray(jl.apply(p, jnp.asarray(x)))
    got = tl(torch.tensor(x)).detach().numpy()
    if act_bits >= 32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        step = float(np.abs(want).max()) / (2 ** (act_bits - 1) - 1)
        assert_codes_close(got, want, step)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("act_bits", [3, 8])
def test_qdense_batchnorm_matches_reference(train, act_bits):
    jl, tl, p = _dense_pair("QDenseBatchNorm", 20, 12, 9,
                            weight_bits=act_bits, act_bits=act_bits)
    x = _rng(10).standard_normal((128, 20)).astype(np.float32)
    jy, jp = jl.apply(p, jnp.asarray(x), train=train)
    ty = tl(torch.tensor(x), train=train).detach().numpy()
    step = float(np.abs(np.asarray(jy)).max()) / (2 ** (act_bits - 1) - 1)
    assert_codes_close(ty, jy, step)
    # the running statistics: updated in train mode, as the reference's
    # new params; untouched in eval mode
    for k in ("mu", "sigma2"):
        np.testing.assert_allclose(tl.to_numpy()[k], np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
        if not train:
            np.testing.assert_array_equal(tl.to_numpy()[k], p[k])


def test_qdense_batchnorm_fold_matches_reference():
    jl, tl, p = _dense_pair("QDenseBatchNorm", 10, 6, 11)
    jk, jb = jl.fold({k: jnp.asarray(v) for k, v in p.items()})
    tk, tb = tl.fold()
    np.testing.assert_allclose(tk.detach().numpy(), np.asarray(jk),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb),
                               rtol=1e-6, atol=1e-7)


CONVS = {
    # IC's stride-4 4x4 SAME conv pads unevenly (0 low, 1 high on 9 px)
    "same_k4_s4": dict(in_ch=3, out_ch=5, kernel=4, stride=4,
                       padding="SAME", relu=True),
    "same_k3_s1": dict(in_ch=4, out_ch=6, kernel=3, stride=1,
                       padding="SAME", relu=True),
    "valid_k3_float": dict(in_ch=3, out_ch=4, kernel=3, padding="VALID",
                           act_bits=32),
    "same_k1_nobias": dict(in_ch=3, out_ch=8, kernel=1, use_bias=False,
                           act_bits=32, weight_bits=32),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_qconv2d_matches_reference(name):
    kw = CONVS[name]
    jl = jql.QConv2D(**kw)
    p = _np(jl.init(jax.random.PRNGKey(12)))
    p["b"] = (0.1 * _rng(12).standard_normal(kw["out_ch"])).astype(
        np.float32)
    tl = tql.QConv2D(**kw).from_numpy(p)
    x = _rng(13).standard_normal((4, 9, 9, kw["in_ch"])).astype(np.float32)
    want = np.asarray(jl.apply(p, jnp.asarray(x)))
    got = tl(torch.tensor(x)).detach().numpy()
    assert got.shape == want.shape
    if jl.aq is None:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert_codes_close(got, want, float(np.abs(want).max()) / 127)


def test_qconv2d_one_bit_weights_are_nan_as_in_the_reference():
    kw = dict(in_ch=3, out_ch=4, kernel=3, padding="VALID", weight_bits=1,
              act_bits=32, weight_kind="binary", use_bias=False)
    jl = jql.QConv2D(**kw)
    p = _np(jl.init(jax.random.PRNGKey(0)))
    tl = tql.QConv2D(**kw).from_numpy(p)
    x = _rng(0).standard_normal((2, 6, 6, 3)).astype(np.float32)
    want = np.asarray(jl.apply(p, jnp.asarray(x)))
    got = tl(torch.tensor(x)).detach().numpy()
    assert np.isnan(want).all() and np.isnan(got).all()


# ---------------------------------------------------------------------------
# the four models
# ---------------------------------------------------------------------------

MODELS = {
    "kws": (dict(in_dim=40, width=24, n_classes=5), (32, 40)),
    "ad": (dict(in_dim=32, width=16, bottleneck=4), (32, 32)),
    "ad_nobn": (dict(in_dim=24, width=12, bottleneck=4, use_bn=False),
                (16, 24)),
    "ic": (dict(in_hw=8, filters=(4, 4), kernels=(1, 4), strides=(1, 4)),
           (4, 8, 8, 3)),
    "cnv": (dict(channels=(4, 4, 8, 8, 8, 8), fc=(16, 16)), (3, 32, 32, 3)),
}
CLASSES = {"kws": "KWSMLP", "ad": "ADAutoencoder", "ad_nobn": "ADAutoencoder",
           "ic": "ICModel", "cnv": "CNVModel"}


@functools.lru_cache(maxsize=None)
def _ref_init(cls, kw, seed):
    """The reference's ``init`` parameters (jitted: the same draws as its
    eager ``init``, compiled once instead of op by op), as numpy."""
    jm = getattr(jtiny, cls)(**dict(kw))
    return _np(jax.jit(jm.init)(jax.random.PRNGKey(seed)))


def _model_pair(name, seed=0):
    kw, shape = MODELS[name]
    jm = getattr(jtiny, CLASSES[name])(**kw)
    tm = getattr(ttiny, CLASSES[name])(**kw)
    p = _ref_init(CLASSES[name], tuple(sorted(kw.items())), seed)
    net = tm.init(torch.Generator().manual_seed(seed)).from_numpy(p)
    x = _rng(seed + 100).standard_normal(shape).astype(np.float32)
    return jm, tm, p, net, x


def _jout(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.mark.parametrize("name", ["kws", "ad", "ad_nobn", "ic"])
@pytest.mark.parametrize("train", [False, True])
def test_model_forward_matches_reference(name, train):
    jm, tm, p, net, x = _model_pair(name)
    jout = jax.jit(jm.apply, static_argnames="train")(p, jnp.asarray(x),
                                                     train=train)
    want = np.asarray(_jout(jout))
    got = net(torch.tensor(x), train=train).detach().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if isinstance(jout, tuple) and train:
        # train mode: the BN statistics equal the reference's new params
        for tp, jp in zip(net.to_numpy()["hidden"], jout[1]["hidden"]):
            for k in ("mu", "sigma2"):
                if k in jp:
                    np.testing.assert_allclose(tp[k], np.asarray(jp[k]),
                                               rtol=1e-5, atol=1e-6)


def test_model_descriptions_match_reference():
    for cls, kw in (("KWSMLP", {}), ("ADAutoencoder", {}),
                    ("ADAutoencoder", dict(in_dim=640, width=128)),
                    ("ICModel", {}), ("CNVModel", {})):
        jm, tm = getattr(jtiny, cls)(**kw), getattr(ttiny, cls)(**kw)
        for attr in ("n_params", "n_weights"):
            if hasattr(jm, attr):
                assert getattr(tm, attr)() == getattr(jm, attr)()
        jc, tc = jm.cost(), tm.cost()
        assert (tc.bops, tc.wm_bits, tc.flops, tc.n_params) == \
            (jc.bops, jc.wm_bits, jc.flops, jc.n_params)
    assert ttiny.KWSMLP().n_weights() == 259_584


def test_ad_anomaly_score_matches_reference():
    jm, tm, p, net, x = _model_pair("ad")
    want = np.asarray(jax.jit(jm.anomaly_score)(p, jnp.asarray(x)))
    got = tm.anomaly_score(net, torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cnv_one_bit_conv_defect_is_pinned_in_both_packages():
    """``QConv2D`` quantizes 1-bit weights with a narrow IntQuantizer whose
    qmax is 0 (``repro/core/qlayers.py:189-201``): the weights are NaN,
    ``ste_sign`` maps every conv output to -1 (``tiny.py:270``), so the
    logits do not depend on the input and the conv-weight gradients are
    NaN — in the reference and, reproduced, in the port."""
    jm, tm, p, net, x = _model_pair("cnv")
    x2 = _rng(7).standard_normal(x.shape).astype(np.float32)
    japply = jax.jit(jm.apply, static_argnames="train")
    j1 = np.asarray(japply(p, jnp.asarray(x), train=False))
    j2 = np.asarray(japply(p, jnp.asarray(x2), train=False))
    t1 = net(torch.tensor(x), train=False).detach().numpy()
    t2 = net(torch.tensor(x2), train=False).detach().numpy()
    assert np.abs(j1 - j2).max() == 0.0 and np.abs(t1 - t2).max() == 0.0
    assert np.abs(j1 - j1[:1]).max() == 0.0      # every row the same
    np.testing.assert_array_equal(t1, j1)

    jg = jax.jit(jax.grad(lambda ps: jnp.sum(jm.apply(ps, jnp.asarray(x),
                                                      train=False))))(
        jax.tree_util.tree_map(jnp.asarray, p))
    net.zero_grad()
    net(torch.tensor(x), train=False).sum().backward()
    for conv, jc in zip(net.convs, jg["convs"]):
        jw = np.asarray(jc["w"])
        assert np.isnan(jw).any()
        np.testing.assert_array_equal(np.isnan(conv.w.grad.numpy()),
                                      np.isnan(jw))
    for fc, jf in zip(net.fcs, jg["fcs"]):
        np.testing.assert_allclose(fc.w.grad.numpy(), np.asarray(jf["w"]),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _kws_loss_pair(jm, tm, n_classes):
    def jloss(ps, batch):
        x, y = batch
        logits = jm.apply(ps, x, train=False)[0]
        lse = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(logits, y[:, None], 1)[:, 0])

    def tloss(net, batch):
        x, y = batch
        logits = tm.apply(net, x, train=False)
        lse = torch.logsumexp(logits, dim=-1)
        return torch.mean(lse - logits.gather(1, y[:, None])[:, 0])

    return jloss, tloss


def _kws_batches(in_dim, n_classes, n):
    r = _rng(21)
    protos = r.standard_normal((n_classes, in_dim)).astype(np.float32) * 2
    out = []
    for _ in range(n):
        y = r.integers(0, n_classes, 32)
        x = (protos[y] + 0.5 * r.standard_normal((32, in_dim))).astype(
            np.float32)
        out.append((x, y.astype(np.int64)))
    return out


#: The trained models keep their quantized weights (3-bit KWS, 8-bit AD)
#: and take float activations: with quantized activations the reference's
#: jitted train step takes other gradients than its own eager one (the
#: ReLU masks of pre-activations that cancel to about 0 hang on the
#: summation's rounding; see the two tests below that pin it), and those
#: gradients are held against the eager reference there.
TRAIN_KW = {"kws": dict(act_bits=32), "ad": dict(act_bits=32)}


def _train_both(name, steps, lr=3e-3):
    kw, shape = MODELS[name]
    kw = dict(kw, **TRAIN_KW[name])
    jm = getattr(jtiny, CLASSES[name])(**kw)
    tm = getattr(ttiny, CLASSES[name])(**kw)
    p = _ref_init(CLASSES[name], tuple(sorted(kw.items())), 3)
    net = tm.init(torch.Generator().manual_seed(3)).from_numpy(p)
    if name == "kws":
        kw = MODELS[name][0]
        batches = _kws_batches(kw["in_dim"], kw["n_classes"], steps)
        jloss, tloss = _kws_loss_pair(jm, tm, kw["n_classes"])
        jb = lambda t: (jnp.asarray(batches[t][0]),  # noqa: E731
                        jnp.asarray(batches[t][1], jnp.int32))
        tb = lambda t: (torch.tensor(batches[t][0]),  # noqa: E731
                        torch.tensor(batches[t][1]))
    else:
        xs = [_rng(30 + t).standard_normal((32, MODELS[name][0]["in_dim"]))
              .astype(np.float32) for t in range(steps)]
        jloss = lambda ps, x: jnp.mean(jnp.square(  # noqa: E731
            jm.apply(ps, x, train=False)[0] - x))
        tloss = lambda n, x: torch.mean(torch.square(  # noqa: E731
            tm.apply(n, x, train=False) - x))
        jb = lambda t: jnp.asarray(xs[t])  # noqa: E731
        tb = lambda t: torch.tensor(xs[t])  # noqa: E731
    jp, jl = jcodesign.train_tiny(jloss, jax.tree_util.tree_map(
        jnp.asarray, p), jb, steps=steps, lr=lr)
    net, tl = tcodesign.train_tiny(tloss, net, tb, steps=steps, lr=lr)
    return _np(jp), net.to_numpy(), jl, tl, p


@pytest.mark.parametrize("name", ["kws", "ad"])
def test_train_tiny_one_step_matches_reference(name):
    jp, tp, jl, tl, p0 = _train_both(name, 1)
    leaves_j = jax.tree_util.tree_leaves(jp)
    leaves_t = jax.tree_util.tree_leaves(tp)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # every BN layer's mu and sigma2 moved (they are trained), the same
    # channels in both
    for tpl, jpl, p in zip(tp["hidden"], jp["hidden"], p0["hidden"]):
        for k in ("mu", "sigma2"):
            moved = np.abs(jpl[k] - p[k]) > 0
            assert moved.any()
            np.testing.assert_array_equal(np.abs(tpl[k] - p[k]) > 0, moved)


@pytest.mark.parametrize("name", ["kws", "ad"])
def test_train_tiny_losses_over_five_steps_match_reference(name):
    _, _, jl, tl, _ = _train_both(name, 5)
    assert len(tl) == 5 and all(isinstance(v, float) for v in tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


@functools.lru_cache(maxsize=1)
def _kws_grads():
    """The KWS loss's gradients at the seeded parameters: the reference's
    eager ``jax.grad``, its ``jax.jit(jax.grad)``, the two losses, and
    the port's autograd (numpy dicts)."""
    jm, tm, p, net, _ = _model_pair("kws", seed=3)
    kw = MODELS["kws"][0]
    xb, yb = _kws_batches(kw["in_dim"], kw["n_classes"], 1)[0]
    jloss, tloss = _kws_loss_pair(jm, tm, kw["n_classes"])
    ps = jax.tree_util.tree_map(jnp.asarray, p)
    batch = (jnp.asarray(xb), jnp.asarray(yb, jnp.int32))
    eager, jitted = _np(jax.grad(jloss)(ps, batch)), _np(
        jax.jit(jax.grad(jloss))(ps, batch))
    losses = (float(jloss(ps, batch)), float(jax.jit(jloss)(ps, batch)))
    tloss(net, (torch.tensor(xb), torch.tensor(yb))).backward()
    port = [{k: q.grad.numpy() for k, q in layer.named_parameters()}
            for layer in net.hidden]
    return eager, jitted, losses, port


def test_reference_jitted_gradients_differ_from_its_eager_ones():
    """Pinned on the reference (jax 0.9.0, CPU): ``jax.jit(jax.grad(f))``
    of a KWS loss through stacked QDenseBatchNorm layers differs from
    ``jax.grad(f)`` by far more than rounding, while the loss agrees to
    1e-6. The port's autograd equals the eager gradients."""
    eager, jitted, (l_eager, l_jit), port = _kws_grads()
    np.testing.assert_allclose(l_jit, l_eager, rtol=1e-6)
    worst_jit = 0.0
    for tg, je, jj in zip(port, eager["hidden"], jitted["hidden"]):
        for k in je:
            np.testing.assert_allclose(tg[k], je[k], rtol=1e-4, atol=1e-5)
            worst_jit = max(worst_jit, float(np.abs(jj[k] - je[k]).max()))
    assert worst_jit > 1e-3


@pytest.mark.parametrize("act_bits", [3, 32])
def test_low_bit_activation_gradients_hang_on_float_rounding(act_bits):
    """Why the jitted reference and the card take other first steps: with
    3-bit activations the pre-activations of a hidden layer are sums of
    few lattice values, and many cancel to within float rounding of 0, so
    the ReLU masks the straight-through gradient passes depend on the
    summation's rounding. The same port computation in float32 and float64
    gives the same loss (1e-6) but flips weight-gradient signs; with float
    activations the gradients agree to 1e-6."""
    model = ttiny.KWSMLP(in_dim=40, width=24, n_classes=5,
                         act_bits=act_bits)
    r = _rng(0)
    x = torch.tensor(r.standard_normal((32, 40)).astype(np.float32))
    y = torch.tensor(r.integers(0, 5, 32))
    out = []
    for dt in (torch.float32, torch.float64):
        net = model.init(torch.Generator().manual_seed(1)).to(dt)
        logits = model.apply(net, x.to(dt), train=False)
        loss = torch.mean(torch.logsumexp(logits, -1)
                          - logits.gather(1, y[:, None])[:, 0])
        loss.backward()
        out.append((float(loss), net.hidden[0].w.grad.double()))
    (l32, g32), (l64, g64) = out
    assert abs(l32 - l64) <= 1e-6 * abs(l64)
    flips = int((torch.sign(g32) != torch.sign(g64)).sum())
    if act_bits == 3:
        assert flips > 0.01 * g64.numel()
        assert float((g32 - g64).abs().max()) > 0.1 * float(g64.abs().max())
    else:
        assert flips == 0
        torch.testing.assert_close(g32, g64, rtol=1e-6, atol=1e-6)


def test_mu_and_sigma2_receive_gradients_in_both_packages():
    eager, _, _, port = _kws_grads()
    for tg, jh in zip(port, eager["hidden"]):
        for k in ("mu", "sigma2"):
            assert np.abs(jh[k]).max() > 0 and np.abs(tg[k]).max() > 0
            np.testing.assert_allclose(tg[k], jh[k], rtol=1e-4, atol=1e-5)


def test_train_tiny_accepts_a_list_of_tensors_and_untouched_params():
    w = torch.tensor([1.0, -2.0])
    unused = torch.tensor([3.0])
    w.requires_grad_(True)
    unused.requires_grad_(True)
    _, losses = tcodesign.train_tiny(lambda ps, _: (ps[0] ** 2).sum(),
                                     [w, unused], lambda t: None, steps=3,
                                     lr=0.1)
    jw, jl = jcodesign.train_tiny(
        lambda ps, _: (ps[0] ** 2).sum(),
        [jnp.asarray([1.0, -2.0]), jnp.asarray([3.0])], lambda t: 0,
        steps=3, lr=0.1)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw[0]),
                               rtol=1e-6)
    assert float(unused) == 3.0 == float(jw[1][0])
    np.testing.assert_allclose(losses, jl, rtol=1e-6)


@pytest.mark.parametrize("ladder,tol", [((32, 8, 6, 4, 3, 2, 1), 0.02),
                                        ((32, 8, 4), 0.0),
                                        ((16, 3, 2), 0.5)])
def test_bitwidth_descent_equals_reference(ladder, tol):
    def quality(bits):
        return 0.9 - 0.3 * np.exp(-bits / 2.0), float(bits * 1000)

    j = jcodesign.bitwidth_descent(quality, bit_ladder=ladder, tolerance=tol)
    t = tcodesign.bitwidth_descent(quality, bit_ladder=ladder, tolerance=tol)
    assert t.entries == j.entries and t.chosen_bits == j.chosen_bits
