"""The port's numpy-only copies and the MLP streamliner against the JAX
package: the synthetic datasets (``data.synthetic``), the search drivers
(``core.search``: ASHA, BO-lite, the predictor sweep, the Pareto front),
``streamline_mlp`` / ``StreamlinedMLP`` and ``constant_fold``
(``core.streamline``).

Synthetic batches, search results, integer weights, threshold banks and
scales must be equal; the streamlined MLP's integer stages equal bit for
bit and its logits within rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qir as jqir
from repro.core import qlayers as jql
from repro.core import search as jsearch
from repro.core import streamline as jstream
from repro.data import synthetic as jsyn
from repro_torch.core import qir as tqir
from repro_torch.core import search as tsearch
from repro_torch.core import streamline as tstream
from repro_torch.data import synthetic as tsyn
from _torch_threads import one_torch_thread  # noqa: F401


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

DATASETS = {
    "images": (dict(seed=3), dict(step=5, batch_size=6)),
    "mel": (dict(dim=64, rank=8, seed=1), dict(step=2, batch_size=40,
                                                anomaly_frac=0.25)),
    "mel_default": (dict(), dict(step=0, batch_size=16)),
    "mfcc": (dict(seed=0), dict(step=7, batch_size=64)),
    "mfcc_balanced": (dict(dim=64, seed=2), dict(step=9, batch_size=30,
                                                  balanced=True)),
    "tokens": (dict(vocab=97, seq_len=12, seed=4), dict(step=1,
                                                         batch_size=3)),
}
CLASSES = {"images": "SyntheticImages", "mel": "SyntheticMelWindows",
           "mel_default": "SyntheticMelWindows", "mfcc": "SyntheticMFCC",
           "mfcc_balanced": "SyntheticMFCC", "tokens": "SyntheticTokens"}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_synthetic_batches_equal_reference(name):
    init, call = DATASETS[name]
    cls = CLASSES[name]
    j = getattr(jsyn, cls)(**init).batch(**call)
    t = getattr(tsyn, cls)(**init).batch(**call)
    if isinstance(j, dict):
        assert sorted(j) == sorted(t)
        j, t = [j[k] for k in sorted(j)], [t[k] for k in sorted(t)]
    for a, b in zip(t, j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mfcc_class_probs_equal_reference():
    np.testing.assert_array_equal(tsyn.SyntheticMFCC().class_probs(),
                                  jsyn.SyntheticMFCC().class_probs())


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

def _space(mod):
    return [mod.Choice("filters", (2, 4, 8, 16)), mod.Choice("k", (1, 3)),
            mod.Choice("stride", (1, 2, 4))]


def _objective(cfg, budget, rng):
    return (0.9 - 0.2 * np.exp(-cfg["filters"] / 6.0) - 0.03 * cfg["stride"]
            + 0.01 * cfg["k"] + rng.normal(0, 0.02 / np.sqrt(budget)))


@pytest.mark.parametrize("kw", [dict(n_trials=12, seed=0),
                                dict(n_trials=20, r_min=2, eta=3,
                                     max_rung=2, seed=5)])
def test_asha_equals_reference(kw):
    jb, jt = jsearch.asha_search(_objective, _space(jsearch), **kw)
    tb, tt = tsearch.asha_search(_objective, _space(tsearch), **kw)
    assert (tb.config, tb.rung, tb.score) == (jb.config, jb.rung, jb.score)
    assert [(t.config, t.rung, t.score, t.budget_used, t.alive)
            for t in tt] == [(t.config, t.rung, t.score, t.budget_used,
                              t.alive) for t in jt]


@pytest.mark.parametrize("seed", [0, 3])
def test_bo_equals_reference(seed):
    jc, jh = jsearch.bo_search(_objective, _space(jsearch), n_trials=24,
                               n_startup=6, seed=seed)
    tc, th = tsearch.bo_search(_objective, _space(tsearch), n_trials=24,
                               n_startup=6, seed=seed)
    assert tc == jc and th == jh


@pytest.mark.parametrize("method", ["bo", "asha"])
def test_predictor_sweep_and_pareto_equal_reference(method):
    def predict(feats):
        return 0.1 * feats["filters"] / feats["stride"] + 0.05 * feats["k"]

    acc = lambda cfg: 0.8 + 0.01 * cfg["filters"] - 0.02 * cfg["stride"]  # noqa
    kw = dict(method=method, n_trials=16, seed=1, accuracy_fn=acc)
    j = jsearch.predictor_sweep(predict, dict, _space(jsearch), **kw)
    t = tsearch.predictor_sweep(predict, dict, _space(tsearch), **kw)
    assert t == j
    pts = [(r["predicted_ms"], r["accuracy"]) for r in t["rows"]]
    assert tsearch.pareto_front(pts) == jsearch.pareto_front(pts)


# ---------------------------------------------------------------------------
# streamline_mlp and constant_fold
# ---------------------------------------------------------------------------

def _mlp(bits, seed):
    dims = [20, 16, 12]
    layers = [jql.QDenseBatchNorm(dims[i], dims[i + 1], weight_bits=bits,
                                  act_bits=bits) for i in range(2)]
    key = jax.random.PRNGKey(seed)
    r = np.random.default_rng(seed)
    params = []
    for i, l in enumerate(layers):
        p = _np(l.init(jax.random.fold_in(key, i)))
        n = dims[i + 1]
        p.update(gamma=r.uniform(0.5, 1.5, n).astype(np.float32),
                 beta=(0.2 * r.standard_normal(n)).astype(np.float32),
                 mu=(0.1 * r.standard_normal(n)).astype(np.float32),
                 sigma2=r.uniform(0.5, 2.0, n).astype(np.float32))
        params.append(p)
    head = {"w": r.standard_normal((12, 4)).astype(np.float32),
            "b": r.standard_normal(4).astype(np.float32)}
    return layers, params, head


@pytest.mark.parametrize("bits", [3, 4, 8])
def test_streamline_mlp_equals_reference(bits):
    layers, params, head = _mlp(bits, bits)
    j = jstream.streamline_mlp(layers, params, 0.05, head)
    t = tstream.streamline_mlp(
        [tqir.LayerBits(l.weight_bits, l.act_bits) for l in layers], params,
        0.05, head)
    assert len(t.stages) == len(j.stages)
    for a, b in zip(t.stages, j.stages):
        np.testing.assert_array_equal(a.w_int.numpy(), np.asarray(b.w_int))
        np.testing.assert_array_equal(a.thresholds.numpy(),
                                      np.asarray(b.thresholds))
        assert a.out_scale == b.out_scale and a.act_bits == b.act_bits
    x = np.random.default_rng(1).integers(-127, 128, (50, 20)).astype(
        np.int32)
    np.testing.assert_allclose(t(torch.tensor(x)).numpy(),
                               np.asarray(j(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t.predict(torch.tensor(x)).numpy(),
                                  np.asarray(j.predict(jnp.asarray(x))))


def test_streamline_mlp_reads_the_port_layers_and_their_parameters():
    from repro_torch.core import qlayers as tql

    layers, params, head = _mlp(4, 0)
    tl = [tql.QDenseBatchNorm(l.in_dim, l.out_dim, weight_bits=4,
                              act_bits=4).from_numpy(p)
          for l, p in zip(layers, params)]
    t = tstream.streamline_mlp(tl, [l.to_numpy() for l in tl], 0.05, head)
    j = jstream.streamline_mlp(layers, params, 0.05, head)
    for a, b in zip(t.stages, j.stages):
        np.testing.assert_array_equal(a.thresholds.numpy(),
                                      np.asarray(b.thresholds))


def test_constant_fold_equals_reference():
    r = np.random.default_rng(0)
    w = r.standard_normal((6, 5)).astype(np.float32)
    graphs = []
    for qir in (jqir, tqir):
        g = qir.Graph(inputs=["x"], outputs=["y"])
        g.initializers["w"] = w
        g.nodes.append(qir.Node("Quant", "qw", ["w"], ["wq"],
                                attrs={"bits": 4}))
        g.nodes.append(qir.Node("Dense", "d", ["x", "wq"], ["y"]))
        graphs.append(g)
    jg = jstream.constant_fold(graphs[0])
    tg = tstream.constant_fold(graphs[1])
    assert [n.name for n in tg.nodes] == [n.name for n in jg.nodes] == ["d"]
    np.testing.assert_array_equal(tg.initializers["wq"],
                                  np.asarray(jg.initializers["wq"]))
