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
  * The rank-local step (``launch.dryrun.rank_trees`` /
    ``trace_step``) of reduced llama3-8b on a (4, 2) mesh over torch's
    fake process group of 8 ranks (a child process: the group is
    process-wide): the collectives the counter sees equal, type by type
    in count and bytes, the port's own schedule, written out in
    ``_train_schedule`` / ``_decode_schedule``; its prefill's FLOPs
    within ``MINIMESH_FLOPS_RTOL`` of the reference's partitioned HLO on
    the same (4, 2) mesh (8 forced host devices, the in-process lowering
    of ``tests/test_multidevice.py::test_dryrun_cell_inprocess_minimesh``),
    and so the prefills of the strategies (``MINI_STRATEGIES``: reduced
    llama3-8b under ``seqpar``, reduced grok-1 under ``ep``), each under
    the same rules on both sides.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
                                        "bias": False, "int8_out": False,
                                        "acc_out": False},
                            2.0 * m * k * n,
                            float(m * k + k * n + 4 * n + 4 * m * n))]
    assert rep.bytes_accessed == m * k + k * n + 4 * n + 4 * m * n
    assert out.shape == (m, n) and out.dtype == torch.float32
    # the accumulator mode: the same operations, no scale read, 4 bytes
    # an output element
    out, rep = analyze_call(ops.qmatmul, x.to(device), w.to(device), None)
    assert rep.stats.flops == 2 * m * k * n
    assert rep.kernels[0][1]["acc_out"] is True
    assert rep.bytes_accessed == m * k + k * n + 4 * m * n
    assert out.shape == (m, n) and out.dtype == torch.int32
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


# ---------------------------------------------------------------------------
# the rank-local step on a (4, 2) mesh of the fake process group
# ---------------------------------------------------------------------------

#: the rank-local prefill's FLOPs against the reference's partitioned HLO
MINIMESH_FLOPS_RTOL = 0.10
MINI_DATA, MINI_MODEL = 4, 2
#: (kind, seq, global batch) of each traced step
MINI_STEPS = (("train", 16, 8), ("decode", 32, 8), ("prefill", 64, 8))
#: the prefills traced on both sides under a strategy's rules:
#: (arch, strategy)
MINI_STRATEGIES = (("llama3-8b", "seqpar"), ("grok-1-314b", "ep"))

MINI_PORT = """
import json
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import init_fake_process_group, make_elastic_mesh
from repro_torch.parallel.sharding import use_mesh_rules
init_fake_process_group({world})
mesh = make_elastic_mesh({model})
assert tuple(mesh.shape) == ({data}, {model})
cfg = get_config("llama3-8b").reduced()
out = {{}}
for kind, seq, batch in {steps}:
    shape = ShapeConfig(kind, seq, batch, kind)
    model, trees = dryrun._abstract_trees(cfg, shape, 16)
    rules = dryrun.arch_rules(cfg, mesh,
                              dryrun.batch_logical_axes(batch, mesh))
    with use_mesh_rules(mesh, rules):
        rep = dryrun.trace_step(model, shape,
                                dryrun.rank_trees(model, shape, trees))
    out[kind] = {{"by_type": rep.stats.by_type,
                 "by_count": rep.stats.by_count,
                 "flops": rep.stats.flops}}
kind, seq, batch = {steps}[-1]
shape = ShapeConfig(kind, seq, batch, kind)
for arch, strategy in {strategies}:
    cfg = get_config(arch).reduced()
    model, trees = dryrun._abstract_trees(cfg, shape, 16)
    rules = dryrun.arch_rules(cfg, mesh,
                              dryrun.batch_logical_axes(batch, mesh))
    rules.update(dryrun.combined_strategy_rules(strategy, cfg, mesh, shape))
    with use_mesh_rules(mesh, rules):
        rep = dryrun.trace_step(model, shape,
                                dryrun.rank_trees(model, shape, trees))
    out[arch + " " + strategy] = {{"flops": rep.stats.flops,
                                  "by_count": rep.stats.by_count}}
print(json.dumps(out))
"""

MINI_REFERENCE = """
import os, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={world}"
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import SHAPES
from repro.launch.dryrun import (arch_rules, batch_shardings,
                                 combined_strategy_rules, input_specs)
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model import Model
from repro.parallel.sharding import use_mesh_rules
shape = dataclasses.replace(SHAPES["train_4k"], seq_len={seq},
                            global_batch={batch})
mesh = Mesh(np.array(jax.devices()).reshape({data}, {model}),
            ("data", "model"))
out = {{}}
for arch, strategy in (("llama3-8b", "baseline"),) + {strategies}:
    cfg = get_config(arch).reduced()
    rules = arch_rules(cfg, mesh, ("data",))
    rules.update(combined_strategy_rules(strategy, cfg, mesh, shape))
    with use_mesh_rules(mesh, rules):
        model = Model(cfg)
        psh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                           model.param_specs(),
                           is_leaf=lambda x: isinstance(x, P))
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        bsh = {{k: v for k, v in batch_shardings(
            cfg, shape, mesh, ("data",)).items() if k != "labels"}}
        bs = {{k: v for k, v in input_specs(cfg, shape).items()
              if k != "labels"}}
        compiled = jax.jit(model.prefill, in_shardings=(psh, bsh)).lower(
            params, bs).compile()
    key = "flops" if strategy == "baseline" else arch + " " + strategy
    out[key] = analyze_hlo(compiled.as_text()).flops
print(json.dumps(out))
"""


def _child(code: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def minimesh():
    """(the port's rank-0 statistics by step kind, the reference's
    partitioned prefill FLOPs), both children run at once."""
    fmt = dict(world=MINI_DATA * MINI_MODEL, data=MINI_DATA,
               model=MINI_MODEL)
    port = _child(MINI_PORT.format(steps=MINI_STEPS,
                                   strategies=MINI_STRATEGIES, **fmt))
    _, seq, batch = MINI_STEPS[2]
    ref = _child(MINI_REFERENCE.format(seq=seq, batch=batch,
                                       strategies=MINI_STRATEGIES, **fmt))
    outs = [p.communicate(timeout=300) for p in (port, ref)]
    for p, (_, err) in zip((port, ref), outs):
        assert p.returncode == 0, err[-4000:]
    return (json.loads(outs[0][0].strip().splitlines()[-1]),
            json.loads(outs[1][0].strip().splitlines()[-1]))


def _count(sched):
    """{kind: (count, bytes)} of a list of (kind, float32 elements)."""
    out = {}
    for kind, n in sched:
        c, b = out.get(kind, (0, 0.0))
        out[kind] = (c + 1, b + 4.0 * n)
    return out


def _mini_dims(seq, batch):
    cfg = get_config("llama3-8b").reduced()
    m, n = MINI_MODEL, MINI_DATA
    return cfg, m, n, batch // n * seq


def _train_schedule(seq, batch):
    """The port's collectives in one rank's train step of reduced
    llama3-8b on the (4, 2) mesh (every rule splits over "model" = 2:
    heads, kv heads, flattened heads, d_ff, vocab; batch and fsdp over
    "data" = 4; remat "full"; T = the rank's B / 4 x S tokens; float32):

      * the embedding: the FSDP all-gather of its (V/2, d/4) block, and
        the all-reduce of the vocab-split lookups (T, d);
      * each layer, in the forward and again in remat's recompute: the
        FSDP all-gathers of wq, wk, wv, wo, wi_gate, wi_up and the MLP's
        wo (7), and Megatron's ``g``, the all-reduce of the attention's
        and the MLP's partial outputs (T, d) (2), but for the MLP's in
        the recompute: torch's checkpoint stops recomputing once it
        holds every tensor the backward saved, and nothing after the
        block's last all-reduce is saved;
      * the head: the FSDP all-gather of its (d/4, V/2) block;
      * the vocab-parallel loss: the all-reduces of the max, the sum of
        exponentials and the label's logit over the vocab group (T each),
        and over the batch group the count of labels and the two
        numerators (scalars);
      * the backward: the numerators' transposes (2 scalars); the head's
        ``f`` (T, d) and its FSDP reduce-scatter, an all-reduce of the
        gathered (d, V/2) gradient (``gather_blocks``' backward, which
        keeps the rank's block); each layer's 7 such reduce-scatters and
        the two ``f`` all-reduces of its input's gradient (T, d); the
        embedding's reduce-scatter;
      * ``reduce_grads``: the all-reduce over the data group of each
        gradient that no data rank splits (norm1, norm2 stacked, the
        final norm); the clipping norm's one all-reduce (a scalar)."""
    cfg, m, n, T = _mini_dims(seq, batch)
    d, H, K, hd, f, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, cfg.d_ff, cfg.vocab, cfg.n_layers)
    weights = [d * H // m * hd, d * K // m * hd, d * K // m * hd,
               H * hd // m * d, d * f // m, d * f // m, f // m * d]
    ag = [V // m * d] + weights * (2 * L) + [d * V // m]
    ar = [T * d] + [T * d] * (2 * L + L) + [T] * 3 + [1] * 3
    ar += [1] * 2 + [T * d, d * V // m] + (weights + [T * d] * 2) * L
    ar += [V // m * d] + [L * d, L * d, d] + [1]
    return _count([("all-gather", x) for x in ag]
                  + [("all-reduce", x) for x in ar])


def _decode_schedule(seq, batch):
    """The port's collectives in one rank's decode step of reduced
    llama3-8b on the (4, 2) mesh (Bl = the rank's B / 4 rows, one token
    each; the cache (Bl, S / 2, K, hd) a layer):

      * the embedding: its FSDP all-gather and the vocab all-reduce
        (Bl, d);
      * each layer: the FSDP all-gathers of wq, wk, wv, wo, wi_gate,
        wi_up and the MLP's wo (7); the all-gathers of the rank's heads of
        q, k and v, so that every rank holds them whole (Bl H hd,
        Bl K hd, Bl K hd); the softmax combine over the "kv_seq" group,
        an all-reduce with MAX of the partial maxima (Bl H) and one of the
        rescaled weighted sums and sums (Bl H (hd + 1)); Megatron's ``g``
        after the attention's and the MLP's row-parallel outputs
        (Bl, d);
      * the head's FSDP all-gather."""
    cfg, m, n, Bl = _mini_dims(1, batch)
    d, H, K, hd, f, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, cfg.d_ff, cfg.vocab, cfg.n_layers)
    layer_ag = [d * H // m * hd, Bl * H * hd, d * K // m * hd, Bl * K * hd,
                d * K // m * hd, Bl * K * hd, H * hd // m * d, d * f // m,
                d * f // m, f // m * d]
    ag = [V // m * d] + layer_ag * L + [d * V // m]
    ar = [Bl * d] + [Bl * H, Bl * H * (hd + 1), Bl * d, Bl * d] * L
    return _count([("all-gather", x) for x in ag]
                  + [("all-reduce", x) for x in ar])


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_rank_local_collectives_equal_the_ports_schedule(minimesh, kind):
    """Type by type, the count and the output bytes of every collective
    of rank 0's step equal the schedule written out in
    ``_train_schedule`` / ``_decode_schedule`` (no collective goes
    uncounted: the counter sees each c10d op the step issues, on meta
    over the fake group)."""
    port, _ = minimesh
    _, seq, batch = next(s for s in MINI_STEPS if s[0] == kind)
    want = (_train_schedule if kind == "train" else _decode_schedule)(
        seq, batch)
    got = port[kind]
    assert set(got["by_count"]) == set(want), got
    for t, (count, nbytes) in want.items():
        assert got["by_count"][t] == count, (t, got, want)
        assert got["by_type"][t] == nbytes, (t, got, want)


def test_rank_local_prefill_flops_against_the_partitioned_reference(
        minimesh):
    """Rank 0's prefill FLOPs within ``MINIMESH_FLOPS_RTOL`` of the
    reference's partitioned HLO of the same prefill on the same (4, 2)
    mesh: each device's share of the split dots plus the work every
    device repeats."""
    port, ref = minimesh
    assert port["prefill"]["flops"] == pytest.approx(
        ref["flops"], rel=MINIMESH_FLOPS_RTOL)


@pytest.mark.parametrize("arch,strategy", MINI_STRATEGIES)
def test_rank_local_strategy_prefill_flops_against_the_reference(
        minimesh, arch, strategy):
    """Rank 0's prefill FLOPs under ``seqpar`` (the sequence gathered
    before each layer, the same dots) and ``ep`` (the rank's 2 of the 4
    experts, their whole d_ff) within ``MINIMESH_FLOPS_RTOL`` of the
    reference's partitioned HLO under the same rules; ``seqpar``
    reduce-scatters where the baseline all-reduces."""
    port, ref = minimesh
    key = f"{arch} {strategy}"
    assert port[key]["flops"] == pytest.approx(ref[key],
                                               rel=MINIMESH_FLOPS_RTOL)
    if strategy == "seqpar":
        assert port[key]["by_count"]["reduce-scatter"] > 0


def test_the_exchange_is_counted_as_an_all_to_all(one_rank_group):
    """The mamba ``in_proj`` exchange (``exchange_column_blocks``) is an
    all-to-all of the rank's block, output bytes counted, on any group:
    here a one-rank one, where the collective runs itself."""
    from repro_torch.parallel.collectives import _ExchangeColumnBlocks

    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    group = dist.group.WORLD
    y, rep = analyze_call(_ExchangeColumnBlocks.apply, x, group, 2)
    assert torch.equal(y, x)
    assert rep.stats.by_type == {"all-to-all": 96.0}
    assert rep.stats.by_count == {"all-to-all": 1}
