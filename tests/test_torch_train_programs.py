"""The training steps and the stage programs as compiled programs
(``core.programs.StepProgram``, ``CompiledTinyModel._stage_fn``), on the
CPU against the reference and the plain steps.

  * ``core.codesign.tiny_adam``'s step (``train_tiny``'s) against the
    reference's jitted ``train_tiny`` at ``test_torch_qat.py``'s bars
    (parameters within 1e-5), the step counter advanced in place and the
    state returned the tensors it was given (the donation).
  * The launcher's step through its program equals the plain step bit for
    bit over 3 steps, the state donated; on a (1, 1) mesh of a one-rank
    ``gloo`` group it equals the meshless step bit for bit (no collective
    runs); a checkpoint saved between two program steps holds its own
    step's state.
  * What the programs capture runs on the ``meta`` device without a host
    read (the CPU's check that a graph can hold it): the QAT step of a
    KWS MLP and the launcher's step of reduced internlm2-1.8b. The tiny
    models' integer stages do not run on meta (the K1/K2/K3 wrappers
    raise there, ``test_torch_dryrun.py::test_other_wrappers_raise_on_meta``),
    so the stage programs are held on the goldens instead:
    ``stage_outputs``, ``streaming_host`` and ``stage_latencies``' spans
    against the reference's.

On the CPU a program calls its function (``core.programs``); the replays
are held against the eager steps on the card (``chip_smoke.py``, phase
28).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import codesign as jcodesign
from repro.core.qir import Graph as JGraph
from repro.deploy import compile_graph as jcompile
from repro.obs import Tracer as JTracer
from repro.obs.report import stage_medians_ms as jstage_medians_ms
from repro_torch.checkpoint.checkpoint import restore
from repro_torch.configs import get_config
from repro_torch.core import codesign as tcodesign
from repro_torch.core.programs import StepProgram
from repro_torch.core.pytree import leaves
from repro_torch.core.qir import Graph as TGraph
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.deploy import compile_graph as tcompile
from repro_torch.launch.dryrun import arch_rules, batch_logical_axes
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import tiny as ttiny
from repro_torch.models.model import Model
from repro_torch.obs import Tracer as TTracer
from repro_torch.obs.report import stage_medians_ms as tstage_medians_ms
from repro_torch.optim.adamw import make_optimizer
from repro_torch.parallel.sharding import shard_tree, use_mesh_rules
from repro_torch.train.loop import LoopConfig, run_training
from repro_torch.train.steps import (TrainState, make_train_step,
                                     train_state_specs)
from _torch_threads import one_torch_thread  # noqa: F401

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDENS = ("kws", "ad", "ic", "cnv")
ARCH = "internlm2-1.8b"


class _NoHostRead(TorchDispatchMode):
    """Fails on any op that reads a tensor's values on the host or sizes
    an output by them."""

    READS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func not in self.READS, f"host read: {func}"
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# train_tiny's step
# ---------------------------------------------------------------------------

def _tiny_loss(ps, batch):
    x, y = batch
    return torch.mean(torch.square(x @ ps[0] + ps[1] - y))


def _jtiny_loss(ps, batch):
    x, y = batch
    return jnp.mean(jnp.square(x @ ps[0] + ps[1] - y))


def test_tiny_adam_steps_match_reference_and_donate_their_state():
    """Three steps of ``tiny_adam``'s program on a linear least-squares
    loss against the reference's ``train_tiny``: parameters within 1e-5,
    losses within 1e-5; the counter reads 3 and every step returns the
    state tensors it was given."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((6, 3)).astype(np.float32)
    b0 = rng.standard_normal(3).astype(np.float32)
    batches = [(rng.standard_normal((8, 6)).astype(np.float32),
                rng.standard_normal((8, 3)).astype(np.float32))
               for _ in range(3)]
    params = [torch.tensor(w0, requires_grad=True),
              torch.tensor(b0, requires_grad=True)]
    prog, state = tcodesign.tiny_adam(_tiny_loss, params, lr=0.05)
    held = leaves(state)
    losses = []
    for x, y in batches:
        got, loss = prog(state, (torch.tensor(x), torch.tensor(y)))
        assert all(a is b for a, b in zip(leaves(got), held))
        losses.append(float(loss))
    assert state[3] is held[-1] and int(state[3]) == 3
    assert state[3].dtype == torch.int32
    jp, jl = jcodesign.train_tiny(
        _jtiny_loss, [jnp.asarray(w0), jnp.asarray(b0)],
        lambda t: (jnp.asarray(batches[t][0]), jnp.asarray(batches[t][1])),
        steps=3, lr=0.05)
    for p, j in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)


def test_qat_step_runs_on_meta_without_a_host_read():
    """The QAT step of a 3-bit KWS MLP (``train_tiny``'s, as
    ``bench.table1_models`` trains it) on the meta device: one step
    through the program's eager function with no host read."""
    model = ttiny.KWSMLP(in_dim=40, width=24, n_classes=5)
    net = model.init(torch.Generator().manual_seed(1)).to("meta")
    w = torch.ones(5, device="meta")

    def loss_fn(n, batch):
        x, y = batch
        logits = model.apply(n, x, train=False)
        lse = torch.logsumexp(logits, dim=-1)
        lab = logits.gather(1, y[:, None])[:, 0]
        return torch.mean((lse - lab) * w[y])

    prog, state = tcodesign.tiny_adam(loss_fn, net, lr=2e-3)
    assert prog.device.type == "meta"
    batch = (torch.empty((16, 40), device="meta"),
             torch.empty(16, dtype=torch.int64, device="meta"))
    with _NoHostRead():
        _, loss = prog.eager(state, batch)
    assert loss.device.type == "meta" and loss.shape == ()


# ---------------------------------------------------------------------------
# the launcher's step
# ---------------------------------------------------------------------------

def _lm(seed=0):
    cfg = get_config(ARCH).reduced()
    m = Model(cfg)
    return m, m.init(torch.Generator().manual_seed(seed), device="cpu")


def _batches(cfg, n=3):
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=32)
    return [data.batch(s, 4) for s in range(n)]


def _state_values(state):
    return [t.detach().clone() for t in leaves(state)]


def _assert_same_values(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_launcher_step_program_equals_the_plain_step_and_donates():
    """Three steps through ``StepProgram(make_train_step(...))`` and
    three plain steps from the same state: losses, metrics, parameters,
    m, v and the counter equal bit for bit; each program step returns
    the very tensors it was given, the counter advanced in place."""
    m, p = _lm()
    opt = make_optimizer(base_lr=1e-2, warmup=1, total=3)
    batches = _batches(m.cfg)
    plain = TrainState(p, opt.init(p))
    m2, p2 = _lm()
    donated = TrainState(p2, opt.init(p2))
    step = make_train_step(m, opt, microbatches=2)
    prog = StepProgram(make_train_step(m2, opt, microbatches=2), "cpu",
                       name="train_step")
    held = leaves(donated)
    counter = donated.opt.step
    for i, batch in enumerate(batches):
        plain, want = step(plain, batch)
        donated, got = prog(donated, batch)
        assert all(a is b for a, b in zip(leaves(donated), held))
        assert donated.opt.step is counter and int(counter) == i + 1
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    _assert_same_values(_state_values(donated), _state_values(plain))


@pytest.fixture
def one_rank_group():
    """A gloo group of one rank in this process, for the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_step_equals_the_meshless_step(one_rank_group):
    """The launcher's (1, 1) mesh (``--model-parallel 2`` on one rank),
    under its rules: three program steps equal three meshless steps bit
    for bit, and no collective runs (a graph of the step holds none)."""
    m, p = _lm()
    opt = make_optimizer(base_lr=1e-2, warmup=1, total=3)
    batches = _batches(m.cfg)
    plain = TrainState(p, opt.init(p))
    step = make_train_step(m, opt)
    mesh = make_elastic_mesh(2)
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == {"data": 1,
                                                          "model": 1}
    rules = arch_rules(m.cfg, mesh, batch_logical_axes(4, mesh))
    m2 = Model(m.cfg)
    with use_mesh_rules(mesh, rules):
        specs = train_state_specs(m2)
        p2 = shard_tree(m2.init(torch.Generator().manual_seed(0),
                                device="cpu"), specs.params)
    meshed = TrainState(p2, opt.init(p2))
    prog = StepProgram(make_train_step(m2, opt), "cpu", name="train_step")
    real = {name: getattr(dist, name) for name in (
        "all_reduce", "all_gather", "reduce_scatter_tensor",
        "all_to_all_single", "all_gather_into_tensor")}
    calls = []

    def spy(name):
        def run(*a, **k):
            calls.append(name)
            return real[name](*a, **k)
        return run

    try:
        for name in real:
            setattr(dist, name, spy(name))
        for batch in batches:
            plain, want = step(plain, batch)
            with use_mesh_rules(mesh, rules):
                meshed, got = prog(meshed, batch)
            for k in want:
                assert torch.equal(got[k], want[k]), k
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)
    assert calls == []
    _assert_same_values(_state_values(meshed), _state_values(plain))


def test_a_checkpoint_between_program_steps_holds_its_own_step(tmp_path):
    """``run_training`` through the step program, a checkpoint every
    step (the async writer): each checkpoint holds the state its step
    left, not the next step's, which overwrote the same tensors."""
    m, p = _lm()
    opt = make_optimizer(base_lr=1e-2, warmup=1, total=3)
    batches = _batches(m.cfg)
    state = TrainState(p, opt.init(p))
    prog = StepProgram(make_train_step(m, opt), "cpu", name="train_step")
    seen = {}

    def step(s, batch):
        s, met = prog(s, batch)
        seen[int(s.opt.step)] = _state_values(s)
        return s, met

    lcfg = LoopConfig(total_steps=3, ckpt_every=1, keep_n=3,
                      ckpt_dir=str(tmp_path), log_every=1)
    res = run_training(step, state, lambda s: batches[s], lcfg)
    assert res.final_step == 3 and sorted(seen) == [1, 2, 3]
    for n in (1, 2, 3):
        got, at, _ = restore(str(tmp_path), state, step=n)
        assert at == n and int(got.opt.step) == n
        _assert_same_values([t.clone() for t in leaves(got)], seen[n])
    assert not torch.equal(seen[1][0], seen[2][0])


def test_a_restore_is_copied_into_the_programs_state(tmp_path):
    """A resumed ``run_training`` restores into the initial state's own
    tensors (a program's graphs hold them) and ends where the
    uninterrupted run ends, bit for bit."""
    m, p = _lm()
    opt = make_optimizer(base_lr=1e-2, warmup=1, total=3)
    batches = _batches(m.cfg)
    whole = TrainState(p, opt.init(p))
    prog = StepProgram(make_train_step(m, opt), "cpu", name="train_step")
    lcfg = LoopConfig(total_steps=3, ckpt_every=1000,
                      ckpt_dir=str(tmp_path / "whole"), log_every=1)
    run_training(prog, whole, lambda s: batches[s], lcfg)

    m2, p2 = _lm()
    first = TrainState(p2, opt.init(p2))
    prog2 = StepProgram(make_train_step(m2, opt), "cpu", name="train_step")
    cut = dataclasses.replace(lcfg, total_steps=2,
                              ckpt_dir=str(tmp_path / "cut"))
    run_training(prog2, first, lambda s: batches[s], cut)
    m3, p3 = _lm(seed=5)
    resumed = TrainState(p3, opt.init(p3))
    held = leaves(resumed)
    prog3 = StepProgram(make_train_step(m3, opt), "cpu", name="train_step")
    res = run_training(prog3, resumed, lambda s: batches[s],
                       dataclasses.replace(cut, total_steps=3))
    assert res.resumed_from == 2 and res.final_step == 3
    assert leaves(resumed) == held and int(resumed.opt.step) == 3
    _assert_same_values(_state_values(resumed), _state_values(whole))


def test_launcher_step_runs_on_meta_without_a_host_read():
    """The launcher's step (2 microbatches) of reduced internlm2-1.8b on
    meta parameters, state and batch: no host read."""
    cfg = get_config(ARCH).reduced()
    m = Model(cfg)
    params = m.init(None, device="meta")
    opt = make_optimizer()
    state = TrainState(params, opt.init(params))
    prog = StepProgram(make_train_step(m, opt, microbatches=2), "meta",
                       name="train_step")
    batch = {k: torch.as_tensor(v).to("meta")
             for k, v in _batches(cfg, 1)[0].items()}
    with _NoHostRead():
        got, met = prog.eager(state, batch)
    assert all(a is b for a, b in zip(leaves(got), leaves(state)))
    assert met["loss"].device.type == "meta"


# ---------------------------------------------------------------------------
# the stage programs
# ---------------------------------------------------------------------------

def _golden(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.qir.json")) as f:
        s = f.read()
    x = np.load(os.path.join(GOLDEN_DIR, f"{name}.golden.npz"))["x"]
    return JGraph.from_json(s), TGraph.from_json(s), x


def _equal(got, want, label):
    got = got.cpu().numpy()
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=label)


@pytest.mark.parametrize("name", GOLDENS)
def test_stage_programs_match_the_reference_on_the_goldens(name):
    """``stage_outputs`` and ``streaming_host`` through the stage programs
    against the reference's (staged, no Pallas), one program per stage,
    dropped by ``set_megakernel``; ``stage_latencies`` records the
    reference's spans (stage, kind, iteration, in order) and
    ``stage_medians_ms`` reproduces its rows in both packages."""
    jg, tg, x = _golden(name)
    x = x[:8]
    jt, tt = JTracer(), TTracer()
    jm = jcompile(jg, in_scale=jg.meta["in_scale"], use_pallas=False,
                  megakernel=False, tracer=jt)
    cm = tcompile(tg, in_scale=tg.meta["in_scale"], device="cpu",
                  megakernel=False, tracer=tt)
    n = len(cm.schedule.stages)
    for i, (got, want) in enumerate(zip(cm.stage_outputs(x),
                                        jm.stage_outputs(jnp.asarray(x)))):
        _equal(got, want, f"{name} stage {i}")
    assert sorted(cm._stage_programs) == list(range(n))
    y, stats = cm.streaming_host(x, micro_batch=4)
    jy, jstats = jm.streaming_host(jnp.asarray(x), micro_batch=4)
    _equal(y, jy, f"{name} streaming_host")
    assert stats.max_occupancy == jstats.max_occupancy
    rows = cm.stage_latencies(x, iters=2)
    jrows = jm.stage_latencies(jnp.asarray(x), iters=2)
    assert [(r["stage"], r["kind"]) for r in rows] == \
        [(r["stage"], r["kind"]) for r in jrows]
    spans = [s.args for s in tt.spans("stage")]
    assert spans == [s.args for s in jt.spans("stage")] and len(spans) == 2 * n
    assert tstage_medians_ms(tt) == {r["stage"]: r["ms"] for r in rows}
    assert jstage_medians_ms(jt) == {r["stage"]: r["ms"] for r in jrows}
    progs = cm.programs()
    assert progs[-n:] == [cm._stage_programs[i] for i in range(n)]
    cm.set_megakernel(None)
    assert cm._stage_programs == {}
