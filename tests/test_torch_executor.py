"""The slice as a whole: lowering and the compiled executor on the CPU
against the JAX package and the frozen goldens.

For all four goldens (KWS, AD, IC, CNV) and both conv lowerings, the port's
``lower_graph`` equals the reference's stage by stage (kinds, integer
weights, banks, exact-affine constants, scales, geometry), and the port's
``compile_graph(device="cpu")`` reproduces the ``.golden.npz`` stage
outputs and the reference's staged executor (``use_pallas=False,
megakernel=False``): integers bit for bit, float logits within rtol/atol
1e-5 (float association, as ``test_golden.py``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qir import Graph as JGraph
from repro.deploy import compile_graph as jcompile
from repro.deploy import lower as jlower
from repro_torch.core.qir import Graph as TGraph
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.deploy import lower as tlower
from repro_torch.kernels import ops as tops
from _torch_threads import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
MODELS = ("kws", "ad", "ic", "cnv")
LOWERINGS = ("direct", "im2col")


def _load(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.qir.json")) as f:
        s = f.read()
    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.golden.npz"))
    stages = [data[k] for k in sorted(data.files) if k.startswith("stage_")]
    return JGraph.from_json(s), TGraph.from_json(s), data["x"], stages


def _assert_match(got, want, label):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=label)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("lowering", LOWERINGS)
def test_lower_graph_matches_reference_stage_by_stage(name, lowering):
    jg, tg, _, _ = _load(name)
    scale = jg.meta["in_scale"]
    js = jlower.lower_graph(jg, in_scale=scale, conv_lowering=lowering)
    ts = tlower.lower_graph(tg, in_scale=scale, conv_lowering=lowering)
    assert len(js.stages) == len(ts.stages)
    assert ts.in_scale == js.in_scale and ts.meta == js.meta
    assert ts.layer_dims() == js.layer_dims()
    assert (ts.n_fused, ts.n_fused_conv) == (js.n_fused, js.n_fused_conv)
    assert ts.describe() == js.describe()
    for a, b in zip(js.stages, ts.stages):
        assert type(a).__name__ == type(b).__name__
        assert (a.name, a.in_dim, a.out_dim, a.in_scale, a.in_bits) == \
            (b.name, b.in_dim, b.out_dim, b.in_scale, b.in_bits)
        if hasattr(a, "stage"):
            np.testing.assert_array_equal(np.asarray(a.stage.w_int),
                                          b.stage.w_int.numpy())
            np.testing.assert_array_equal(np.asarray(a.stage.thresholds),
                                          b.stage.thresholds.numpy())
            assert (a.stage.out_scale, a.stage.act_bits,
                    a.stage.weight_bits) == \
                (b.stage.out_scale, b.stage.act_bits, b.stage.weight_bits)
            assert a.mm_float == b.mm_float
            assert (a.affine is None) == (b.affine is None)
            if a.affine is not None:
                for ja, tb in zip(a.affine, b.affine):
                    assert tb.dtype == torch.float32
                    np.testing.assert_array_equal(np.asarray(ja), tb.numpy())
        if hasattr(a, "geom"):
            assert vars(a.geom) == vars(b.geom)
            assert a.lowering == b.lowering == lowering
        if type(a).__name__ == "FloatHeadStage":
            np.testing.assert_array_equal(np.asarray(a.w), b.w.numpy())
            np.testing.assert_array_equal(np.asarray(a.b), b.b.numpy())
        if type(a).__name__ == "IntPoolStage":
            assert vars(a) == vars(b)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("lowering", LOWERINGS)
def test_compiled_cpu_matches_golden_and_reference(name, lowering):
    jg, tg, x, want = _load(name)
    scale = jg.meta["in_scale"]
    cm = tcompile(tg, in_scale=scale, conv_lowering=lowering, device="cpu")
    outs = cm.stage_outputs(x)
    assert len(outs) == len(want)
    for i, (got, w) in enumerate(zip(outs, want)):
        _assert_match(got, w, f"{name}[{lowering}] stage {i}")
    jm = jcompile(jg, in_scale=scale, conv_lowering=lowering,
                  use_pallas=False, megakernel=False)
    xj = jnp.asarray(x)
    for i, (got, w) in enumerate(zip(outs, jm.stage_outputs(xj))):
        _assert_match(got, w, f"{name}[{lowering}] vs JAX stage {i}")
    logits = cm.offline(x)
    _assert_match(logits, jm.offline(xj), f"{name}[{lowering}] offline")
    _assert_match(logits, want[-1], f"{name}[{lowering}] offline golden")
    np.testing.assert_array_equal(cm.predict(x).numpy(),
                                  np.asarray(jm.predict(xj)))


@pytest.mark.parametrize("name", MODELS)
def test_apply_kernel_on_cpu_equals_apply_fast_and_ref(name):
    """The kernel entry points (plain versions on CPU tensors) give the
    integers of the reference's fast CPU path (exact float32 GEMM/conv,
    affine short-cut, sorted-bank search) and of the port's ``apply_ref``,
    stage by stage under both lowerings, and count no launch."""
    jg, tg, x, _ = _load(name)
    for lowering in LOWERINGS:
        cm = tcompile(tg, in_scale=tg.meta["in_scale"],
                      conv_lowering=lowering, device="cpu")
        jm = jcompile(jg, in_scale=jg.meta["in_scale"],
                      conv_lowering=lowering, use_pallas=False,
                      megakernel=False)
        h = torch.as_tensor(x)
        tops.reset_launches()
        for s, js in zip(cm.schedule.stages, jm.schedule.stages):
            y = cm._apply_stage(s, h)
            if hasattr(s, "apply_kernel"):
                fast = np.asarray(js.apply_fast(jnp.asarray(h.numpy())))
                np.testing.assert_array_equal(y.numpy(), fast,
                                              err_msg=s.name)
                np.testing.assert_array_equal(s.apply_ref(h).numpy(), fast,
                                              err_msg=s.name)
            h = y
        assert tops.launches == {"threshold_matmul": 0, "conv_threshold": 0,
                                 "mlp_megakernel": 0, "flash_attention": 0,
                                 "flash_attention_bwd": 0,
                                 "multi_threshold": 0, "qmatmul": 0,
                                 "float_head": 0}


@pytest.mark.parametrize("name", MODELS)
def test_reference_interpreter_matches(name):
    jg, tg, x, want = _load(name)
    scale = jg.meta["in_scale"]
    cm = tcompile(tg, in_scale=scale, device="cpu")
    jm = jcompile(jg, in_scale=scale, use_pallas=False, megakernel=False)
    ref = cm.reference(x)
    _assert_match(ref, jm.reference(jnp.asarray(x)), f"{name} reference")
    if name in ("ic", "cnv"):
        # conv exports carry pre-quantized weights, so the unfused graph
        # reproduces the compiled integers; MLP exports keep float weights
        _assert_match(ref, want[-1], f"{name} reference vs golden")


def test_stage_latencies_report_every_stage():
    from repro_torch.obs import Tracer

    _, tg, x, _ = _load("cnv")
    tr = Tracer()
    cm = tcompile(tg, in_scale=tg.meta["in_scale"], device="cpu", tracer=tr)
    rows = cm.stage_latencies(x, iters=3)
    assert [r["stage"] for r in rows] == [s.name for s in cm.schedule.stages]
    assert all(r["ms"] >= 0 for r in rows)
    assert len(tr.spans("stage")) == 3 * len(rows)


def test_ref_chain_fallback_matches_reference():
    """A graph the matcher cannot fuse runs through the fallback float
    interpreter stage, as in the reference."""
    jg, tg, x, _ = _load("kws")
    for g in (jg, tg):
        g.nodes = [n for n in g.nodes if n.op != "Relu" or n.name != "relu1"]
        q = next(n for n in g.nodes if n.name == "quant1")
        q.inputs = ["h1_bn"]
    cm = tcompile(tg, in_scale=tg.meta["in_scale"], device="cpu")
    jm = jcompile(jg, in_scale=jg.meta["in_scale"], use_pallas=False,
                  megakernel=False)
    assert [type(s).__name__ for s in cm.schedule.stages] == \
        [type(s).__name__ for s in jm.schedule.stages]
    assert type(cm.schedule.stages[-1]).__name__ == "RefChainStage"
    _assert_match(cm.offline(x), jm.offline(jnp.asarray(x)), "ref chain")


def test_conv_lowering_env_override(monkeypatch):
    _, tg, _, _ = _load("ic")
    monkeypatch.setenv("REPRO_CONV_LOWERING", "im2col")
    sched = tlower.lower_graph(tg, in_scale=tg.meta["in_scale"])
    assert {s.lowering for s in sched.stages if hasattr(s, "lowering")} == \
        {"im2col"}
    monkeypatch.setenv("REPRO_CONV_LOWERING", "winograd")
    with pytest.raises(ValueError):
        tlower.default_conv_lowering()


def test_compile_graph_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg, _, _ = _load("kws")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcompile(tg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcompile(tg, device="cuda")
