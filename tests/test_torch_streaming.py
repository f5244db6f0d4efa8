"""The port's streaming and wave entry points on the CPU against the JAX
package: the analogue of ``tests/test_golden.py``'s dispatch-mode tests and
``tests/test_streaming_compiled.py``.

For the four goldens and full-width KWS and AD, in both dispatch modes
(staged, ``megakernel=False``; auto, the default) the port's ``offline``,
``streaming_host``, ``streaming_compiled`` and ``submit_wave`` give the
reference's outputs (``use_pallas=False`` with the same ``megakernel``)
and the frozen ``.golden.npz`` ones; the ``StreamingStats`` and the tracer's
segment spans and FIFO counters equal the reference's. Tolerances:
integers exact; float logits within rtol/atol 1e-5 (float association in
the head, as ``tests/test_golden.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qir import Graph as JGraph
from repro.deploy import compile_graph as jcompile
from repro.obs.tracer import Tracer as JTracer
from repro_torch.core.qir import Graph as TGraph
from repro_torch.core.qir import Node, QuantSpec
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.kernels import ops as tops
from repro_torch.obs.tracer import Tracer as TTracer
from repro_torch.serve.faults import FaultError, WaveError
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
MODELS = ("kws", "ad", "ic", "cnv", "full-kws", "full-ad")
MODES = {"staged": False, "auto": None}


def _load(name):
    """(reference graph, port graph, x, frozen last-stage output or None)."""
    if name.startswith("full-"):
        from repro_torch.bench import models

        dims, bits = {"full-kws": (models.KWS_DIMS, models.KWS_BITS),
                      "full-ad": (models.AD_DIMS, models.AD_BITS)}[name]
        s = models.mlp_graph(dims, bits, 2022).to_json()
        rng = np.random.default_rng(len(name))
        x = rng.integers(-127, 128, (7, dims[0])).astype(np.int32)
        return JGraph.from_json(s), TGraph.from_json(s), x, None
    with open(os.path.join(GOLDEN_DIR, f"{name}.qir.json")) as f:
        s = f.read()
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.golden.npz"))
    stages = [data[k] for k in sorted(data.files) if k.startswith("stage_")]
    return JGraph.from_json(s), TGraph.from_json(s), data["x"], stages[-1]


def _compile(name, mode, **kw):
    jg, tg, x, want = _load(name)
    scale = jg.meta.get("in_scale", 1.0 / 127.0)
    jm = jcompile(jg, in_scale=scale, use_pallas=False,
                  megakernel=MODES[mode], **kw)
    tm = tcompile(tg, in_scale=scale, device="cpu", megakernel=MODES[mode],
                  **kw)
    return jm, tm, x, want


def _same(got, want, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, label
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=label)


def _stats(st):
    return {k: getattr(st, k) for k in (
        "micro_batch", "n_micro", "fifo_depths", "max_occupancy",
        "sim_cycles", "mode", "segments", "megakernel")}


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("mode", MODES)
def test_entry_points_equal_reference(name, mode):
    jm, tm, x, frozen = _compile(name, mode)
    planned = [(p.start, p.stop) for p in tm._mega_plans.values()]
    assert planned == [(p.start, p.stop) for p in jm._mega_plans.values()]
    assert bool(planned) == (mode == "auto" and name != "ic")
    xj = jnp.asarray(x)
    tops.reset_launches()
    y_off = tm.offline(x)
    _same(y_off, jm.offline(xj), f"{name}[{mode}] offline")
    if frozen is not None:
        _same(y_off, frozen, f"{name}[{mode}] offline vs golden")
    for entry in ("streaming_host", "streaming_compiled"):
        y, st = getattr(tm, entry)(x, micro_batch=3)
        yj, stj = getattr(jm, entry)(xj, micro_batch=3)
        _same(y, yj, f"{name}[{mode}] {entry}")
        _same(y, y_off, f"{name}[{mode}] {entry} vs offline")
        assert _stats(st) == _stats(stj)
    valid = np.array([True, False, True])
    y_w, mask = tm.submit_wave(x[:3], valid=valid, micro_batch=4)
    yj_w, maskj = jm.submit_wave(xj[:3], valid=valid, micro_batch=4)
    assert mask.tolist() == maskj.tolist() == [True, False, True, False]
    assert y_w.shape[0] == 4
    _same(y_w[torch.from_numpy(mask)], np.asarray(yj_w)[maskj],
          f"{name}[{mode}] submit_wave")
    _same(y_w[torch.from_numpy(mask)], y_off[:3][torch.from_numpy(valid)],
          f"{name}[{mode}] submit_wave vs offline")
    # CPU tensors take the plain versions: no kernel launch is counted
    assert all(v == 0 for v in tops.launches.values())


@pytest.mark.parametrize("name", ("kws", "ad", "cnv"))
def test_forced_fallback_budget_runs_staged(name):
    """A budget too small for the run's weights and banks leaves no plan;
    the outputs stay exact, and the default budget re-admits the plan."""
    jm, tm, x, frozen = _compile(name, "auto")
    assert tm._mega_plans
    tm.set_megakernel(True, budget_bytes=64)
    jm.set_megakernel(True, budget_bytes=64)
    assert tm._mega_plans == {} and jm._mega_plans == {}
    _same(tm.offline(x), frozen, f"{name}[fallback] offline")
    y, st = tm.streaming_compiled(x, micro_batch=2)
    _same(y, frozen, f"{name}[fallback] streaming_compiled")
    assert not st.megakernel
    assert _stats(st) == _stats(jm.streaming_compiled(jnp.asarray(x),
                                                      micro_batch=2)[1])
    tm.set_megakernel(None)
    assert tm._mega_plans


@pytest.mark.parametrize("mode", MODES)
def test_tracer_spans_and_fifo_counters_equal_reference(mode):
    jm, tm, x, _ = _compile("kws", mode)
    jtr, ttr = JTracer(), TTracer()
    jm.set_tracer(jtr)
    tm.set_tracer(ttr)
    for m, xx in ((jm, jnp.asarray(x)), (tm, x)):
        m.streaming_compiled(xx, micro_batch=2)
        m.submit_wave(xx[:2], micro_batch=4)
        m.streaming_host(xx, micro_batch=2)

    def shape(tr):
        return [(e.kind, e.name, e.cat, e.tid, e.value, e.args)
                for e in tr.events()]

    assert shape(ttr) == shape(jtr)
    segs = ttr.spans("segment")
    assert [s.args["megakernel"] for s in segs] == [mode == "auto"] * 2
    assert ttr.counters("fifo0") and ttr.spans("fire")


def test_streaming_host_depth_one_fifos_make_progress():
    """Capacity-1 queues everywhere still drain the whole batch, and the
    observed occupancy respects the forced depths."""
    jm, tm, x, _ = _compile("ad", "auto")
    ones = [1] * (len(tm.schedule.stages) + 1)
    y, st = tm.streaming_host(x, micro_batch=2, fifo_depths=ones)
    _same(y, tm.offline(x), "depth-1")
    assert st.fifo_depths == ones
    assert all(o <= 1 for o in st.max_occupancy[:-1])
    assert _stats(st) == _stats(jm.streaming_host(
        jnp.asarray(x), micro_batch=2, fifo_depths=ones)[1])
    with pytest.raises(ValueError, match="pipeline queues"):
        tm.streaming_host(x, micro_batch=2, fifo_depths=[1, 1])


def test_streaming_host_out_of_order_feed_restores_batch_order():
    _, tm, x, _ = _compile("kws", "staged")
    n_micro = x.shape[0] // 2
    y_rev, _ = tm.streaming_host(x, micro_batch=2,
                                 feed_order=list(reversed(range(n_micro))))
    _same(y_rev, tm.offline(x), "reversed feed")
    with pytest.raises(ValueError, match="permutation"):
        tm.streaming_host(x, micro_batch=2, feed_order=[0] * n_micro)


@pytest.mark.parametrize("mode", MODES)
def test_streaming_pads_a_micro_batch_that_does_not_divide(mode):
    jm, tm, x, _ = _compile("full-kws", mode)      # 7 rows, micro-batch 4
    for entry in ("streaming_compiled", "streaming_host"):
        y, st = getattr(tm, entry)(x, micro_batch=4)
        assert y.shape[0] == 7 and st.n_micro == 2
        _same(y, tm.offline(x), f"{entry} padded tail")
        assert _stats(st) == _stats(
            getattr(jm, entry)(jnp.asarray(x), micro_batch=4)[1])


def test_streaming_compiled_crosses_host_boundary():
    """A schedule with a fallback float chain: the RefChain segment returns
    to the host, everything else is one segment program."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((6, 4)).astype(np.float32) * 0.3
    g = TGraph(inputs=["x"], outputs=["y"],
               initializers={"w": w, "b": np.zeros((4,), np.float32),
                             "m": np.full((4,), 2.0, np.float32)})
    g.nodes = [
        Node("Dense", "d0", ["x", "w", "b"], ["h0"]),
        Node("Relu", "r0", ["h0"], ["h1"]),
        Node("Quant", "q0", ["h1"], ["h2"], quant=QuantSpec(bits=4)),
        Node("Mul", "m0", ["h2", "m"], ["y"]),    # unfusable suffix
    ]
    jg = JGraph.from_json(g.to_json())
    cm = tcompile(g, in_scale=0.1, device="cpu")
    jm = jcompile(jg, in_scale=0.1, use_pallas=False)
    assert [seg.compiled for seg in cm.segments] == [True, False]
    x = rng.integers(-7, 8, (10, 6)).astype(np.int32)
    y_off = cm.offline(x)
    y_cmp, st = cm.streaming_compiled(x, micro_batch=4)   # pads 10 -> 12
    _same(y_cmp, y_off, "host boundary")
    _same(y_cmp, jm.streaming_compiled(jnp.asarray(x), micro_batch=4)[0],
          "host boundary vs reference")
    assert st.segments == [(0, 1), (1, 2)]


def test_submit_wave_zeroes_invalid_rows_on_the_host():
    """Whatever the caller left in an invalid row, the wave runs as if it
    were zero codes, and valid rows are untouched."""
    _, tm, x, _ = _compile("kws", "auto")
    junk = x[:3].copy()
    junk[1] = 127
    valid = [True, False, True]
    y_junk, _ = tm.submit_wave(junk, valid=valid, micro_batch=4)
    zeroed = junk.copy()
    zeroed[1] = 0
    y_zero, mask = tm.submit_wave(zeroed, valid=valid, micro_batch=4)
    _same(y_junk, y_zero, "invalid row zeroed")
    assert mask.tolist() == [True, False, True, False]
    _same(y_zero[3], tm.offline(np.zeros((1,) + x.shape[1:], x.dtype))[0],
          "padding row is code 0")


def test_submit_wave_validation_and_typed_failures():
    _, tm, x, _ = _compile("kws", "auto")
    with pytest.raises(ValueError, match="exceeds micro_batch"):
        tm.submit_wave(x[:3], micro_batch=2)
    with pytest.raises(ValueError, match="valid mask"):
        tm.submit_wave(x[:3], valid=[True, False], micro_batch=4)
    y, mask = tm.submit_wave(torch.as_tensor(x[:2]), micro_batch=4)
    assert mask.tolist() == [True, True, False, False]
    # break the segment pipeline underneath submit_wave: the escaping
    # exception comes back as the typed WaveError, a FaultError
    tm.segments = None
    with pytest.raises(WaveError, match="compiled segment pipeline") as e:
        tm.submit_wave(x[:2], micro_batch=4)
    assert isinstance(e.value, FaultError) and isinstance(e.value,
                                                          RuntimeError)
    # validation stays a ValueError even then
    with pytest.raises(ValueError):
        tm.submit_wave(x[:3], micro_batch=2)
