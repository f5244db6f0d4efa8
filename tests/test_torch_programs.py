"""The compiled programs (``repro_torch.core.programs.Program``: one CUDA
graph per input shape on the card, the function itself on the CPU) and
the entry points that run through them, against the reference's jit
programs.

  * ``deploy.CompiledTorchModel`` against ``CompiledJaxModel`` on one toy
    forward and one set of weights: ``offline``, ``reference`` and
    ``predict``.
  * ``Model.decode_step`` with ``cur_index`` a tensor equals the int form
    bit for bit and the reference within ``LOGIT_TOL``, and makes no
    host read (no ``aten._local_scalar_dense``, no ``nonzero``): what a
    CUDA graph of the step needs.
  * ``ServeEngine``'s tokens, its decode and prefill steps now programs,
    equal the reference engine's.
  * ``apply_tuned`` and ``set_megakernel`` drop the executor's programs,
    as the reference's ``_rebuild`` drops its jit closures.
  * On a card (``cuda``-marked; they skip without one): a capture that
    fails raises and the program never runs the call eagerly instead;
    replays equal the eager function, count the graph's launches and
    return tensors that do not alias. The reference is imported inside
    the tests that compare with it, so that ``pytest -m cuda`` runs this
    file on a machine with a card and no JAX.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.core.programs import Program
from repro_torch.core.pytree import leaves
from repro_torch.core.qir import Graph
from repro_torch.deploy import CompiledTorchModel, compile_graph
from repro_torch.deploy.autotune import TunedConfig
from repro_torch.kernels import ops
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.serving.engine import Request, ServeEngine
from _torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
#: the toy forward's float32 outputs: the two packages sum in other orders
TOY_TOL = dict(rtol=1e-5, atol=1e-5)


def _toy_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((12, 16)).astype(np.float32),
            "b1": rng.standard_normal(16).astype(np.float32),
            "w2": rng.standard_normal((16, 5)).astype(np.float32),
            "b2": rng.standard_normal(5).astype(np.float32)}


def _jax_fwd(p, x):
    import jax.numpy as jnp

    return jnp.maximum(x @ p["w1"] + p["b1"], 0.0) @ p["w2"] + p["b2"]


def _torch_fwd(p, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def test_compiled_torch_model_matches_compiled_jax_model():
    import jax
    import jax.numpy as jnp
    from repro.deploy.executor import CompiledJaxModel

    params = _toy_params()
    x = np.random.default_rng(1).standard_normal((9, 12)).astype(np.float32)
    jm = CompiledJaxModel(_jax_fwd, jax.tree.map(jnp.asarray, params),
                          name="toy")
    tm = CompiledTorchModel(_torch_fwd, params, name="toy", device="cpu")
    assert tm.name == jm.name == "toy"
    for got, want in ((tm.offline(x), jm.offline(jnp.asarray(x))),
                      (tm.reference(x), jm.reference(jnp.asarray(x)))):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOY_TOL)
    np.testing.assert_array_equal(tm.predict(x).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(x))))
    a, b = tm.offline(x), tm.offline(x)
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_program_on_the_cpu_calls_its_function():
    calls = []

    def fn(x, y):
        calls.append(torch.is_grad_enabled())
        return {"sum": x + y, "prod": x * y}

    prog = Program(fn, "cpu", name="toy")
    x, y = torch.arange(4.0, requires_grad=True), torch.ones(4)
    out = prog(x, y)
    assert calls == [False] and len(prog) == 0
    assert torch.equal(out["sum"], x.detach() + 1)
    assert not out["prod"].requires_grad


class _NoHostRead(TorchDispatchMode):
    """Fails on any op that reads a tensor's values on the host or sizes
    an output by them."""

    READS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        assert func not in self.READS, f"host read: {func}"
        return func(*args, **(kwargs or {}))


def _pair(name):
    """(JAX model, params, port model, params) with the reference's
    weights carried across."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.models.model import Model as JModel

    jm = JModel(jget_config(name).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(name).reduced()
    return jm, jp, Model(cfg), params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), cfg, "cpu")


def _decode_forms(m, p, toks):
    """Each step's logits with ``cur_index`` an int and as a tensor (0-d
    for the first half, then per slot), the tensor form under
    ``_NoHostRead``; asserts the two equal bit for bit, caches too."""
    c_int = m.cache_init(2, 16, device="cpu")
    c_dev = m.cache_init(2, 16, device="cpu")
    steps = toks.shape[1]
    out = []
    for t in range(steps):
        tok = torch.from_numpy(toks[:, t:t + 1])
        cur = (torch.tensor(t, dtype=torch.int32) if t < steps // 2
               else torch.tensor([t, t], dtype=torch.int32))
        got_int, c_int = m.decode_step(p, c_int, tok, t)
        with _NoHostRead():
            got, c_dev = m.decode_step(p, c_dev, tok, cur)
        assert torch.equal(got, got_int), t
        out.append(got)
    for a, b in zip(leaves(c_int), leaves(c_dev)):
        assert torch.equal(a, b)
    return out


def test_decode_step_takes_cur_index_as_a_tensor():
    """Reduced llama3-8b, 6 steps: the tensor forms equal the int form bit
    for bit, make no host read, and equal the reference's jitted step."""
    import jax
    import jax.numpy as jnp

    jm, jp, m, p = _pair("llama3-8b")
    toks = np.random.default_rng(2).integers(0, m.cfg.vocab, (2, 6)).astype(
        np.int32)
    jdecode = jax.jit(jm.decode_step)
    jc = jm.cache_init(2, 16)
    for t, got in enumerate(_decode_forms(m, p, toks)):
        want, jc = jdecode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                           jnp.asarray([t, t], jnp.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)


def test_hybrid_decode_step_makes_no_host_read():
    """Reduced jamba (mamba mixers, attention, the MoE's dispatch), 4
    steps: the tensor forms equal the int form and make no host read."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 4)).astype(
        np.int32)
    _decode_forms(m, p, toks)


def test_serve_engine_through_its_programs_matches_reference():
    """Four requests through two slots of reduced qwen1.5-4b (biased q, k,
    v): every request's tokens equal the reference engine's."""
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServeEngine as JServeEngine

    jm, jp, m, p = _pair("qwen1.5-4b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, m.cfg.vocab, n).astype(np.int32)
               for n in (3, 5, 3, 2)]
    outs = []
    for engine, request, kw in ((JServeEngine, JRequest, {}),
                                (ServeEngine, Request, {"device": "cpu"})):
        eng = engine(jm if engine is JServeEngine else m,
                     jp if engine is JServeEngine else p, n_slots=2,
                     max_len=16, **kw)
        reqs = [request(uid=i, prompt=pr, max_new_tokens=3 + i % 2)
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert len(eng.decode_program) == len(eng.prefill_program) == 0


def _golden_kws():
    with open(os.path.join(GOLDEN, "kws.qir.json")) as f:
        g = Graph.from_json(f.read())
    return g, np.load(os.path.join(GOLDEN, "kws.golden.npz"))["x"]


def _hold_programs(cm):
    """Every program the model has made, each holding a stand-in graph."""
    progs = cm.programs()
    for prog in progs:
        prog._graphs["stand-in"] = object()
    return progs


def test_apply_tuned_and_set_megakernel_drop_the_programs():
    g, x = _golden_kws()
    cm = compile_graph(g, in_scale=g.meta["in_scale"], device="cpu")
    want = cm.offline(x)
    cm.streaming_compiled(x, micro_batch=8)
    progs = _hold_programs(cm)
    assert len(progs) == 1 + sum(s.compiled for s in cm.segments)
    cm.set_megakernel(False)
    assert all(len(prog) == 0 for prog in progs)
    assert cm._offline not in progs and cm._segment_programs == {}
    assert torch.equal(cm.offline(x), want)
    cm.streaming_compiled(x, micro_batch=8)
    progs = _hold_programs(cm)
    cfg = TunedConfig(key="kws", platform="torch-cpu", micro_batch=8,
                      block_h={}, fifo_depths=[], modeled_cycles=0,
                      modeled_traffic_bytes=0.0, segment_mode="megakernel")
    cm.apply_tuned(cfg)
    assert all(len(prog) == 0 for prog in progs)
    assert cm._offline not in progs and cm._segment_programs == {}
    y, stats = cm.streaming_compiled(x)
    assert stats.megakernel and torch.equal(y, cm.offline(x))
    assert torch.equal(cm.offline(x), want)


def test_a_dropped_model_or_engine_is_freed_without_a_collection():
    """Programs hold their owner weakly: the last reference to a compiled
    model or an engine frees it (on the card, its graphs' memory) at once,
    with the collector off."""
    import gc
    import weakref

    g, x = _golden_kws()
    cfg = get_config("llama3-8b").reduced()
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    gc.disable()
    try:
        cm = compile_graph(g, in_scale=g.meta["in_scale"], device="cpu")
        cm.offline(x)
        cm.streaming_compiled(x)
        cm.submit_wave(x[:3])
        eng = ServeEngine(m, p, n_slots=2, max_len=16, device="cpu")
        eng.submit(Request(uid=0, prompt=np.asarray([1, 2, 3], np.int32),
                           max_new_tokens=2))
        eng.run_until_drained()
        refs = [weakref.ref(cm), weakref.ref(eng)]
        del cm, eng
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_restore_dispatch_brings_back_its_programs():
    g, x = _golden_kws()
    cm = compile_graph(g, in_scale=g.meta["in_scale"], device="cpu")
    cm.offline(x)
    state = cm.dispatch_state()
    held = cm._offline
    cm.set_megakernel(False)
    assert cm._offline is not held
    cm.restore_dispatch(state)
    assert cm._offline is held and cm.megakernel is None


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_failed_capture_raises_and_never_runs_eagerly(cuda):
    """A function that reads a value on the host cannot be captured: the
    call raises (its warm-up ran once), and so does the next call, which
    does not run the function eagerly in the graph's place."""
    calls = []

    def fn(x):
        calls.append(1)
        return x * float(x.sum())

    prog = Program(fn, cuda, name="host-read")
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match="capture"):
        prog(x)
    assert len(prog) == 0
    n = len(calls)
    with pytest.raises(RuntimeError, match="capture"):
        prog(x)
    assert len(prog) == 0 and len(calls) == n + 2


@pytest.mark.cuda
def test_offline_replays_equal_the_eager_program_and_count_launches(cuda):
    g, x = _golden_kws()
    cm = compile_graph(g, in_scale=g.meta["in_scale"], device=cuda)
    counts = []
    outs = []
    for _ in range(3):
        ops.reset_launches()
        outs.append(cm.offline(x))
        torch.cuda.synchronize()
        counts.append(dict(ops.launches))
    assert counts[0] == counts[1] == counts[2]
    assert counts[0]["mlp_megakernel"] == 1 and counts[0]["float_head"] == 1
    assert len(cm._offline) == 1
    eager = cm._run_all(torch.as_tensor(x, device=cuda))
    for y in outs:
        assert torch.equal(y, eager)
    assert outs[1].data_ptr() != outs[2].data_ptr()
    y, _ = cm.streaming_compiled(x, micro_batch=16)
    assert torch.equal(y[:, :], cm.offline(x))
    wave, mask = cm.submit_wave(x[:5], micro_batch=16)
    assert torch.equal(wave[torch.as_tensor(mask, device=cuda)],
                       cm.offline(x[:5]))


@pytest.mark.cuda
def test_step_program_replays_equal_eager_steps_and_keep_the_state(cuda):
    """``train_tiny``'s step (``codesign.tiny_adam``) on a small 3-bit KWS
    MLP: five steps through the program (a warm-up that captures, then
    replays) equal five eager steps from the same parameters bit for bit,
    losses and parameters; the state is the tensors it was given, one
    graph holds the step; ``stage_outputs`` through the stage programs
    equals the stages run eagerly."""
    from repro_torch.core import codesign
    from repro_torch.core.pytree import leaves
    from repro_torch.core.qir import full_fp32
    from repro_torch.models.tiny import KWSMLP

    model = KWSMLP(in_dim=40, width=24, n_classes=5)
    rng = np.random.default_rng(0)
    batches = [(torch.tensor(rng.standard_normal((16, 40)),
                             dtype=torch.float32, device=cuda),
                torch.tensor(rng.integers(0, 5, 16), device=cuda))
               for _ in range(5)]

    def loss_fn(net, batch):
        x, y = batch
        logits = model.apply(net, x, train=False)
        return torch.mean(torch.logsumexp(logits, -1)
                          - logits.gather(1, y[:, None])[:, 0])

    runs = []
    for graphed in (False, True):
        net = model.init(torch.Generator().manual_seed(1)).to(cuda)
        prog, state = codesign.tiny_adam(loss_fn, net, lr=1e-2)
        held = leaves(state)
        losses = []
        with full_fp32():
            for b in batches:
                state, loss = (prog if graphed else prog.eager)(state, b)
                assert all(a is c for a, c in zip(leaves(state), held))
                losses.append(loss)
        runs.append((torch.stack(losses), [p.detach().clone()
                                            for p in state[0]], len(prog)))
    (le, pe, ge), (lg, pg, gg) = runs
    assert ge == 0 and gg == 1
    assert torch.equal(le, lg)
    assert all(torch.equal(a, b) for a, b in zip(pe, pg))
    g, x = _golden_kws()
    cm = compile_graph(g, in_scale=g.meta["in_scale"], device=cuda,
                       megakernel=False)
    cm.stage_outputs(x)
    got = cm.stage_outputs(x)
    h = torch.as_tensor(x, device=cuda)
    for s, y in zip(cm.schedule.stages, got):
        h = cm._apply_stage(s, h)
        assert torch.equal(y, h)
    assert all(len(p) == 1 for p in cm._stage_programs.values())


@pytest.mark.cuda
def test_a_view_of_the_input_outlives_the_next_call(cuda):
    """A function that returns a view of its input (a flatten stage): the
    first call's result (the warm-up's) and every replay's keep their
    values when the next call copies another input into the graph's
    buffer."""
    prog = Program(lambda x: x.reshape(-1), cuda, name="flatten")
    xs = [torch.full((2, 3), float(i), device=cuda) for i in range(3)]
    outs = [prog(x) for x in xs]
    torch.cuda.synchronize()
    for i, y in enumerate(outs):
        assert torch.equal(y, torch.full((6,), float(i), device=cuda))
