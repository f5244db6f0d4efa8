"""The port's op-trace analysis (``launch/hlo_analysis.py``) against the
reference's HLO analysis of the same graphs.

  * Micro graphs: the FLOPs equal the reference's ``analyze_hlo`` of the
    jitted JAX graph exactly: a dot, a loop of 7, nested loops of 3 x 5
    (the port's Python loops against the reference's scans), the conv,
    and the plain gradient graph; with remat the port counts the
    recomputed dot again (remat >= plain, as the reference's
    ``test_flops_counted_inside_remat`` asks; XLA on the CPU merges the
    recompute with the forward, the port does not), on the CPU and on
    meta alike.
  * ``shape_bytes`` on the reference's parser cases.
  * Collectives: an all-reduce of f32[128, 4] on a one-rank ``gloo``
    group gives the reference's bytes, kind and count for its hand-written
    HLO all-reduce; an all-gather counts its result.
  * Kernels: K5, K6 and K6's backward count once by their own formulas
    (``KERNEL_COUNTS``, the ``chip_smoke.py`` rows'), equal on the CPU and
    on meta; their plain versions count nothing; a kernel without a
    formula raises; the observers are removed after the trace.
  * Whole reduced steps: ``Model.prefill`` and the train step (AdamW, remat
    full and none) at S 64, so both packages take the naive attention,
    against the reference's compiled HLO: dense configs equal exactly
    (``DENSE_RTOL`` 0); the prefill of a mamba config equal, its train step
    within ``SSM_TRAIN_RTOL`` 1%. The gap: in the train step XLA rewrites
    the scan's batched matrix-vector einsum (``y = h . C``,
    ``ssm.selective_scan_chunked``; ``btds,bts->btd`` in the reference)
    and most of its gradients into a multiply and a reduce, which its
    analysis does not count as a dot; the port runs them as ``bmm`` and
    counts them. The MoE's one-hot dispatch is not a dot in either
    package.
  * Memory: the arguments, the result and the peak of a known graph.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro.configs import get_config as jget_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model import Model as JModel
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch.hlo_analysis import (KERNEL_COUNTS, HloStats,
                                             analyze_call, flash_live_pairs,
                                             shape_bytes)
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.optim.adamw import make_optimizer
from repro_torch.train.steps import TrainState, make_train_step

DENSE_RTOL = 0.0
SSM_TRAIN_RTOL = 0.01
DEVICES = ("cpu", "meta")


def _ref_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def _stats(fn, *args):
    """The port's counterpart of ``analyze_hlo``: a call's statistics."""
    return analyze_call(fn, *args)[1].stats


def _ones(*shape, device="cpu"):
    return torch.ones(shape, device=device)


# ---------------------------------------------------------------------------
# micro graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", DEVICES)
def test_dot_flops_equal_the_reference(device):
    M, K, N = 8, 16, 4
    want = _ref_flops(lambda a, b: a @ b, jnp.ones((M, K)), jnp.ones((K, N)))
    got = _stats(lambda a, b: a @ b, _ones(M, K, device=device),
                 _ones(K, N, device=device)).flops
    assert got == want == 2 * M * N * K


@pytest.mark.parametrize("device", DEVICES)
def test_loop_of_seven_equals_the_reference_scan(device):
    M, n = 8, 7

    def jf(x, w):
        return jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                            length=n)[0]

    def tf(x, w):
        for _ in range(n):
            x = x @ w
        return x

    want = _ref_flops(jf, jnp.ones((M, M)), jnp.ones((M, M)))
    got = _stats(tf, _ones(M, M, device=device),
                 _ones(M, M, device=device)).flops
    assert got == want == n * 2 * M ** 3


@pytest.mark.parametrize("device", DEVICES)
def test_nested_loops_equal_the_reference_scans(device):
    def jf(x, w):
        def outer(c, _):
            return jax.lax.scan(lambda c, _: (c @ w, None), c, None,
                                length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    def tf(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    want = _ref_flops(jf, jnp.ones((4, 4)), jnp.ones((4, 4)))
    got = _stats(tf, _ones(4, 4, device=device),
                 _ones(4, 4, device=device)).flops
    assert got == want == 15 * 2 * 4 ** 3


@pytest.mark.parametrize("device", DEVICES)
def test_conv_flops_equal_the_reference(device):
    def jf(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = _ref_flops(jf, jnp.ones((1, 8, 8, 3)), jnp.ones((3, 3, 3, 4)))
    got = _stats(lambda x, w: F.conv2d(x, w, padding=1),
                 _ones(1, 3, 8, 8, device=device),
                 _ones(4, 3, 3, 3, device=device)).flops
    assert got == want == 2 * 64 * 4 * 9 * 3


@pytest.mark.parametrize("device", DEVICES)
def test_flops_counted_inside_remat(device):
    """value_and_grad of sum(tanh(x @ w)) over x and w: the plain graph's
    three dots equal the reference's; under remat the port re-runs the
    forward dot in the backward and counts it (remat >= plain)."""
    def jloss(remat):
        f = lambda x, w: jnp.tanh(x @ w)                      # noqa: E731
        f = jax.checkpoint(f) if remat else f
        return lambda x, w: jnp.sum(f(x, w))

    def tstep(remat):
        def run(x, w):
            x, w = x.requires_grad_(True), w.requires_grad_(True)
            f = lambda x, w: torch.tanh(x @ w)                 # noqa: E731
            y = (checkpoint(f, x, w, use_reentrant=False) if remat
                 else f(x, w))
            loss = y.sum()
            return loss.detach(), torch.autograd.grad(loss, (x, w))
        return run

    x, w = jnp.ones((8, 8)), jnp.ones((8, 8))
    ref = {r: _ref_flops(jax.value_and_grad(jloss(r), argnums=(0, 1)), x, w)
           for r in (False, True)}
    got = {r: _stats(tstep(r), _ones(8, 8, device=device),
                     _ones(8, 8, device=device)).flops
           for r in (False, True)}
    assert got[False] == ref[False] == 3 * 2 * 8 ** 3
    assert ref[True] >= ref[False]
    assert got[True] == got[False] + 2 * 8 ** 3     # the recomputed dot


def test_shape_bytes_counterpart_of_the_parser():
    assert shape_bytes((torch.float32, (8, 4))) == 128
    assert shape_bytes((torch.bfloat16, (10,))) == 20
    assert shape_bytes((torch.int8, (3, 3))) == 9
    assert shape_bytes((torch.float32, (4,)), (torch.int32, (2,))) == 24
    assert shape_bytes((torch.bool, (16,))) == 16
    assert shape_bytes(torch.empty(2, 3, dtype=torch.float16,
                                   device="meta")) == 12


def test_zero_collectives_on_a_single_device_graph():
    stats = _stats(lambda x: x * 2, torch.ones(4))
    assert stats.collective_bytes == 0.0 and stats.by_type == {}


def test_hlo_stats_scaled_and_add():
    a = HloStats(flops=2.0, collective_bytes=4.0,
                 by_type={"all-reduce": 4.0}, by_count={"all-reduce": 1})
    b = a.scaled(3)
    assert (b.flops, b.collective_bytes, b.by_type, b.by_count) == (
        6.0, 12.0, {"all-reduce": 12.0}, {"all-reduce": 3})
    b.add(a)
    assert (b.flops, b.by_count) == (8.0, {"all-reduce": 4})


@pytest.fixture
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collective_bytes_of_an_all_reduce_equal_the_reference(
        one_rank_group):
    """The reference's hand-written HLO all-reduce of f32[128, 4] against
    ``dist.all_reduce`` of the same array on a one-rank gloo group."""
    hlo = """
HloModule test

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %r = f32[] add(%a, %b)
}

ENTRY %main (x: f32[128,4]) -> f32[128,4] {
  %x = f32[128,4] parameter(0)
  ROOT %ar = f32[128,4] all-reduce(%x), to_apply=%add
}
"""
    want = analyze_hlo(hlo)
    got = _stats(lambda t: dist.all_reduce(t), torch.ones(128, 4))
    assert got.collective_bytes == want.collective_bytes == 128 * 4 * 4
    assert got.by_type == want.by_type == {"all-reduce": 2048}
    assert got.by_count == want.by_count == {"all-reduce": 1}
    x = torch.ones(16, 4)
    got = _stats(lambda t: dist.all_gather([torch.empty_like(t)], t),
                 x)
    assert got.by_type == {"all-gather": 256} and got.by_count == {
        "all-gather": 1}


# ---------------------------------------------------------------------------
# kernels: once, by their own formulas, on the CPU and on meta
# ---------------------------------------------------------------------------

def _flash_inputs(device, b=2, h=4, hkv=2, s=40, d=16, grad=False):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(device)
               for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    if grad:
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=8),
                                dict(causal=True, q_offset=3, kv_len=30)])
def test_flash_forward_and_backward_count_once_on_cpu_and_meta(kw):
    b, h, hkv, s, d = 2, 4, 2, 40, 16
    pairs = flash_live_pairs(s, s, kw["causal"], kw.get("window", 0),
                             kw.get("q_offset", 0), kw.get("kv_len"))
    fwd, bwd = 4.0 * b * h * d * pairs, 10.0 * b * h * d * pairs

    def run(q, k, v):
        out = ops.flash_attention(q, k, v, **kw)
        return torch.autograd.grad(out.sum(), (q, k, v))

    counts = {}
    for device in DEVICES:
        _, rep = analyze_call(run, *_flash_inputs(device, grad=True))
        names = [k[0] for k in rep.kernels]
        assert names == ["flash_attention", "flash_attention_bwd"]
        assert [k[2] for k in rep.kernels] == [fwd, bwd]
        # nothing else in the graph is a dot: the plain versions inside
        # the calls count nothing
        assert rep.stats.flops == fwd + bwd
        counts[device] = (rep.stats.flops, rep.bytes_accessed,
                          [k[1] for k in rep.kernels])
        out, rep = analyze_call(lambda *t: ops.flash_attention(*t, **kw),
                                *_flash_inputs(device))
        assert rep.stats.flops == fwd and len(rep.kernels) == 1
        assert out.shape == (b, h, s, d)
    assert counts["cpu"] == counts["meta"]
    assert not ops.kernel_observers and not ops.inside_kernel()


@pytest.mark.parametrize("device", DEVICES)
def test_qmatmul_counts_once_by_its_formula(device):
    m, k, n = 37, 64, 24
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    sc = torch.rand(n, generator=g)
    out, rep = analyze_call(ops.qmatmul, *(t.to(device) for t in (x, w, sc)))
    assert rep.stats.flops == 2 * m * k * n
    assert rep.kernels == [("qmatmul", {"m": m, "k": k, "n": n,
                                        "bias": False, "int8_out": False},
                            2.0 * m * k * n,
                            float(m * k + k * n + 4 * n + 4 * m * n))]
    assert rep.bytes_accessed == m * k + k * n + 4 * n + 4 * m * n
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert set(KERNEL_COUNTS) == {"qmatmul", "flash_attention",
                                  "flash_attention_bwd"}


def test_a_kernel_without_a_formula_raises():
    x = torch.zeros(4, 8, dtype=torch.int32)
    w = torch.zeros(8, 3, dtype=torch.int8)
    t = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="threshold_matmul"):
        analyze_call(ops.threshold_matmul, x, w, t)
    assert not ops.kernel_observers and not ops.inside_kernel()
    # outside a trace the wrapper is what it was
    assert ops.threshold_matmul(x, w, t).shape == (4, 3)


def test_memory_figures_of_a_known_graph():
    """x (4 KiB) -> y = x * 2 (4 KiB, freed) -> z = y + 1 (4 KiB, the
    result): arguments 4 KiB, peak 12 KiB, output 4 KiB, nothing
    aliased."""
    def f(x):
        y = x * 2
        return y + 1

    for device in DEVICES:
        _, rep = analyze_call(f, torch.ones(1024, device=device))
        assert rep.memory_analysis() == {
            "argument_size_in_bytes": 4096, "output_size_in_bytes": 4096,
            "temp_size_in_bytes": 8192, "alias_size_in_bytes": 0}
        assert rep.bytes_accessed == 4 * 4096


# ---------------------------------------------------------------------------
# whole reduced steps against the reference's compiled HLO
# ---------------------------------------------------------------------------

B, S = 2, 64


def _steps(arch, remat):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), remat=remat)
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=remat)
    jm, tm = JModel(jcfg), Model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "labels": torch.from_numpy(labels)}
    prefill = (_ref_flops(jm.prefill, jp, {"tokens": jbatch["tokens"]}),
               _stats(tm.prefill, tp,
                      {"tokens": tbatch["tokens"]}).flops)
    jopt, topt = jmake_optimizer(), make_optimizer()
    train = (_ref_flops(jsteps.make_train_step(jm, jopt),
                        jsteps.TrainState(jp, jopt.init(jp)), jbatch),
             _stats(make_train_step(tm, topt),
                    TrainState(tp, topt.init(tp)), tbatch).flops)
    return prefill, train


@pytest.mark.parametrize("remat", ["full", "none"])
def test_dense_reduced_steps_equal_the_reference(remat):
    (jp, tp), (jt, tt) = _steps("llama3-8b", remat)
    assert tp == pytest.approx(jp, rel=DENSE_RTOL, abs=0)
    assert tt == pytest.approx(jt, rel=DENSE_RTOL, abs=0)


def test_mamba_reduced_steps_against_the_reference():
    (jp, tp), (jt, tt) = _steps("falcon-mamba-7b", "full")
    assert tp == jp
    # the port counts the scan's matrix-vector bmm that XLA strength-
    # reduces (module docstring); the gap is that, and small
    assert jt < tt <= jt * (1 + SSM_TRAIN_RTOL)
