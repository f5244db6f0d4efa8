"""QIR in the port against the JAX package: JSON round trips, the
``export_qmlp`` exporter and the ``Graph.run`` interpreter.

The port reads the very ``*.qir.json`` goldens and writes byte-identical
JSON. ``Graph.run`` agrees exactly on the Quant outputs of the conv goldens
(every float there is an exact multiple of a po2 step) and within
rtol/atol 1e-5 on logits (float association, as ``test_golden.py``).
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.core import qir as jqir
from repro.models.tiny import ADAutoencoder, KWSMLP
from repro_torch.core import qir as tqir

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
MODELS = ("kws", "ad", "ic", "cnv")


def _text(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.qir.json")) as f:
        return f.read()


@pytest.mark.parametrize("name", MODELS)
def test_golden_json_round_trip_identical(name, tmp_path):
    s = _text(name)
    tg = tqir.Graph.from_json(s)
    assert tg.to_json() == jqir.Graph.from_json(s).to_json()
    path = str(tmp_path / "g.qir.json")
    tg.save(path)
    assert tqir.Graph.load(path).to_json() == tg.to_json()


def _numpy_params(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), params)


@pytest.mark.parametrize("model,key", [(KWSMLP(width=32), 10),
                                       (ADAutoencoder(width=24), 11)])
def test_export_qmlp_json_identical(model, key):
    params = _numpy_params(model.init(jax.random.PRNGKey(key)))
    hidden, _ = model.layers()
    kw = dict(meta={"model": type(model).__name__}, freeze_scales=True,
              in_scale=1.0 / 127.0)
    want = jqir.export_qmlp(hidden, params["hidden"], params["head"], **kw)
    bits = [tqir.LayerBits(weight_bits=ld.weight_bits, act_bits=ld.act_bits)
            for ld in hidden]
    got = tqir.export_qmlp(bits, params["hidden"], params["head"], **kw)
    assert got.to_json() == want.to_json()


def test_export_qmlp_dynamic_quant_json_identical():
    model = KWSMLP(width=16)
    params = _numpy_params(model.init(jax.random.PRNGKey(3)))
    hidden, _ = model.layers()
    want = jqir.export_qmlp(hidden, params["hidden"], params["head"])
    got = tqir.export_qmlp(hidden, params["hidden"], params["head"])
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("name", MODELS)
def test_graph_run_matches_reference_on_goldens(name):
    s = _text(name)
    jg, tg = jqir.Graph.from_json(s), tqir.Graph.from_json(s)
    x = np.load(os.path.join(GOLDEN_DIR, f"{name}.golden.npz"))["x"]
    quants = [n.outputs[0] for n in jg.nodes if n.op == "Quant"]
    outs = list(jg.outputs) + quants
    for g in (jg, tg):
        g.outputs = outs
    feeds = {"x": np.asarray(x, np.float32) * jg.meta["in_scale"]}
    want = jg.run(feeds)
    got = tg.run(feeds, device="cpu")
    for q in quants:
        if name in ("ic", "cnv"):
            np.testing.assert_array_equal(got[q], want[q], err_msg=q)
        else:
            np.testing.assert_allclose(got[q], want[q], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5,
                               atol=1e-5)


def _op_graph():
    """A small graph touching every interpreter op the goldens do not:
    SAME max pool, BatchNorm, dynamic Quant, MultiThreshold, Mul, TopK."""
    rng = np.random.default_rng(4)
    N = tqir.Node
    init = {
        "cw": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
        "cb": rng.standard_normal(4).astype(np.float32),
        "g": rng.uniform(0.5, 1.5, 4).astype(np.float32),
        "be": rng.standard_normal(4).astype(np.float32),
        "mu": rng.standard_normal(4).astype(np.float32),
        "v": rng.uniform(0.5, 2.0, 4).astype(np.float32),
        "thr": np.sort(rng.integers(-3, 4, (36, 5)), axis=1).astype(np.int32),
        "two": np.full((36,), 2, np.int32),
    }
    nodes = [
        N("Conv2D", "c", ["x", "cw", "cb"], ["c"],
          {"stride": 2, "padding": "SAME"}),
        N("BatchNorm", "bn", ["c", "g", "be", "mu", "v"], ["bn"]),
        N("MaxPool", "p", ["bn"], ["p"], {"window": 3, "stride": 2,
                                           "padding": "SAME"}),
        N("Quant", "q", ["p"], ["q"], {},
          tqir.QuantSpec(bits=4, signed=True, narrow=False)),
        N("Flatten", "f", ["q"], ["f"]),
        N("MultiThreshold", "mt", ["f", "thr"], ["mt"]),
        N("Mul", "m", ["mt", "two"], ["m"]),
        N("Relu", "r", ["m"], ["r"]),
        N("TopK", "k", ["r"], ["k"]),
    ]
    return nodes, init


def test_graph_run_every_op_matches_reference():
    nodes, init = _op_graph()
    tg = tqir.Graph(nodes=nodes, initializers=init, inputs=["x"],
                    outputs=["q", "mt", "r", "k"])
    jg = jqir.Graph.from_json(tg.to_json())
    x = np.random.default_rng(5).standard_normal((3, 11, 11, 2)).astype(
        np.float32)
    want = jg.run({"x": x})
    got = tg.run({"x": x}, device="cpu")
    np.testing.assert_allclose(got["q"], want["q"], rtol=1e-6, atol=1e-6)
    for k in ("mt", "r", "k"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_max_pool_on_integer_codes_pads_with_the_minimum():
    x = -np.arange(1, 1 + 2 * 5 * 5 * 3, dtype=np.int32).reshape(2, 5, 5, 3)
    import jax.numpy as jnp
    want = jax.lax.reduce_window(jnp.asarray(x), jnp.iinfo(jnp.int32).min,
                                 jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1),
                                 "SAME")
    got = tqir.max_pool_nhwc(torch.from_numpy(x), 2, 2, "SAME")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_graph_run_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tqir.Graph.from_json(_text("kws"))
    with pytest.raises(RuntimeError, match="CUDA"):
        g.run({"x": np.zeros((1, 490), np.float32)})
