"""The port's SPMD train step over a multi-rank mesh on the CPU, against
the JAX package's GSPMD step and against the port on one rank.

Four ``gloo`` ranks, started once for the module (this file run as four
processes, ``__main__`` -> ``_worker``, a ``file://`` store under the
pytest tmp dir), and the reference in a subprocess with four forced host
devices (``XLA_FLAGS`` must be set before JAX starts, as in
``tests/test_multidevice.py``), both running at once. The weights are
the port's seeded ``Model.init`` on the CPU, handed to both sides as
numpy (the port's ranks take them through ``params_from_numpy``); the
batches are ``SyntheticTokens``' (8 x 16), the same numpy arrays on both
sides. Each case trains 3 steps (``make_optimizer(base_lr=1e-3,
warmup=1, total=10)``, as the reference's
``test_spmd_train_step_8dev_matches_1dev``) under
``launch.dryrun.arch_rules`` of the mesh, on both sides:

  * reduced llama3-8b on (2, 2) and (4, 1) (heads and kv heads split, or
    pure data parallelism with FSDP) and (1, 4), where its 2 kv heads do
    not divide the model axis: each rank keeps the kv head its q head
    reads; the same config with 6 heads and 6 kv heads on (1, 4): the
    heads stay whole and each rank keeps its block of the flattened
    attention output before ``wo``;
  * reduced grok-1 (the MoE in the whole step) with 8-bit QAT (the
    fake-quant scale of the whole weight), 2 microbatches, remat "full"
    and the chunked attention (K6's plain version), on (2, 2), with a
    capacity factor of 4 (= its experts), so that no token is dropped
    whether the tokens are dispatched all at once or a data rank's at a
    time, and the one-rank gradients are the same function;
  * reduced llama3-8b on (2, 2) with labels masked (-1) 48 times in the
    first data rank's rows and 8 times in the second's, each step: the
    loss is the global mean, not a mean of the ranks' means;
  * reduced llama3-8b with its embedding table tied to the head, and
    reduced qwen2-vl-2b (seeded normal frames in place of tokens, q / k /
    v biases, M-RoPE), on (2, 2);
  * the strategies of ``launch.dryrun.strategy_rules`` on top of
    ``arch_rules``, on both sides (``STRATEGY``): ``seqpar`` on reduced
    llama3-8b on (2, 2) and (1, 4) (the residual stream split into
    sequence blocks over the model axis: 8 or 4 of the 16 positions a
    rank); ``ep`` on reduced grok-1 (4 experts, top-2) and reduced
    llama4-scout (4 experts, top-1, a shared expert) on (2, 2) and
    (1, 4) (2 or 1 whole experts a rank, the dense MLPs whole), at a
    capacity factor of 4 (no token dropped, whatever the dispatch
    grouping).

Bars: the port's 3 losses within rtol 2e-3 of the reference's 4-device
run of the same config (``LOSS_RTOL``, the reference's own bar between 8
devices and one; one run a config, ``REFERENCE_RUN``),
the same on every rank; the first step's gradients (``step_grads``, the
rank's blocks gathered whole) within 1e-5 of each leaf's largest |g|
of the port's one-rank gradients (``GRAD_TOL``).

Also in the four ranks: the counterpart of the reference's
``test_elastic_mesh_shrink_and_restore`` (reduced internlm2-1.8b: one
step on (2, 2), a checkpoint, then a restore onto a (1, 2) mesh over
ranks 0 and 1 and one more step, against a one-rank restore of the same
checkpoint; the checkpoint's arrays against a one-rank save of the
gathered state, bit for bit); ``launch.train --reduced
--model-parallel 2`` in the four-rank group (mesh {data: 2, model: 2},
a falling loss) on llama3-8b and on falcon-mamba-7b; ``shard_tree`` /
``gather_tree`` round trips of every config's spec tree; a checkpoint of
reduced grok-1's train state written under the baseline rules on (2, 2),
restored under ``ep`` on (1, 4), written again there and restored under
the baseline on (2, 2): every restore the blocks of the state, both
checkpoints the same arrays, bit for bit.
"""

import dataclasses
import json
import logging
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import restore, save
from repro_torch.configs import get_config, list_configs
from repro_torch.core.pytree import leaves, leaves_with_paths, unflatten_like
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch.dryrun import (arch_rules, batch_logical_axes,
                                      combined_strategy_rules)
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.optim.adamw import make_optimizer
from repro_torch.parallel.sharding import (gather_tree, local_block,
                                           shard_tree, spec_axes,
                                           spec_leaves, use_mesh_rules)
from repro_torch.train.steps import (TrainState, batch_to_device,
                                     make_train_step, step_grads,
                                     train_state_specs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
BATCH, SEQ, STEPS = 8, 16, 3
#: the reference's bar between its SPMD step and one device
LOSS_RTOL = 2e-3
#: of each leaf's largest |g|: float32 sums in another order
GRAD_TOL = 1e-5
WORKER_TIMEOUT_S = 240
ELASTIC = "internlm2-1.8b"
#: name -> (arch, config fields replaced, mesh (data, model),
#: microbatches, label mask)
CASES = {
    "llama_2x2": ("llama3-8b", {}, (2, 2), 1, False),
    "llama_4x1": ("llama3-8b", {}, (4, 1), 1, False),
    "llama_1x4": ("llama3-8b", {}, (1, 4), 1, False),
    "heads6_1x4": ("llama3-8b", {"n_heads": 6, "n_kv_heads": 6}, (1, 4), 1,
                   False),
    "grok_2x2": ("grok-1-314b", {"weight_bits": 8, "capacity_factor": 4.0,
                                 "attn_impl": "chunked", "remat": "full"},
                 (2, 2), 2, False),
    "masked_2x2": ("llama3-8b", {}, (2, 2), 1, True),
    "tied_2x2": ("llama3-8b", {"tie_embeddings": True}, (2, 2), 1, False),
    "qwen2vl_2x2": ("qwen2-vl-2b", {}, (2, 2), 1, False),
    "llama_seqpar_2x2": ("llama3-8b", {}, (2, 2), 1, False),
    "llama_seqpar_1x4": ("llama3-8b", {}, (1, 4), 1, False),
    "grok_ep_2x2": ("grok-1-314b", {"capacity_factor": 4.0}, (2, 2), 1,
                    False),
    "grok_ep_1x4": ("grok-1-314b", {"capacity_factor": 4.0}, (1, 4), 1,
                    False),
    "scout_ep_2x2": ("llama4-scout-17b-16e", {"capacity_factor": 4.0},
                     (2, 2), 1, False),
    "scout_ep_1x4": ("llama4-scout-17b-16e", {"capacity_factor": 4.0},
                     (1, 4), 1, False),
}
#: case -> the strategy whose rules it runs under (the baseline's
#: otherwise), on both sides
STRATEGY = {name: strategy for name in CASES
            for strategy in ("seqpar", "ep") if f"_{strategy}_" in name}
#: the checkpoint reshard's config and its two (strategy, mesh) layouts
RESHARD = ("grok-1-314b", (("baseline", (2, 2)), ("ep", (1, 4))))


def _reference_runs():
    """case -> the case whose reference run it is held to: one 4-device
    run a config, on the mesh of its first case (GSPMD computes the same
    step on any mesh shape)."""
    first, out = {}, {}
    for name, (arch, over, _, micro, masked) in CASES.items():
        key = json.dumps([arch, over, micro, masked,
                          STRATEGY.get(name, "baseline")], sort_keys=True)
        out[name] = first.setdefault(key, name)
    return out


REFERENCE_RUN = _reference_runs()


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _batches(cfg, masked):
    """The steps' batches; a config that takes embeddings gets seeded
    normal frames in place of the tokens, as the launcher feeds it."""
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=SEQ)
    out = []
    for t in range(STEPS):
        b = data.batch(t, BATCH)
        if masked:
            b["labels"][:BATCH // 2, :12] = -1
            b["labels"][BATCH // 2:, :2] = -1
        if not cfg.embed_inputs:
            b = {"embeds": np.random.default_rng(t).standard_normal(
                (BATCH, SEQ, cfg.d_model), dtype=np.float32),
                 "labels": b["labels"]}
        out.append(b)
    return out


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.numpy())
            for k, v in tree.items()}


def _weights(arch, over, seed=0):
    model = Model(_cfg(arch, over))
    return _numpy_tree(model.init(torch.Generator().manual_seed(seed),
                                  device="cpu"))


def _opt():
    return make_optimizer(base_lr=1e-3, warmup=1, total=10)


def _rules(cfg, mesh, strategy="baseline"):
    """``arch_rules`` of the mesh, the strategy's rules on top."""
    rules = arch_rules(cfg, mesh, batch_logical_axes(BATCH, mesh))
    rules.update(combined_strategy_rules(strategy, cfg, mesh, None))
    return rules


# ---------------------------------------------------------------------------
# the four ranks
# ---------------------------------------------------------------------------

def _case(name, inputs):
    """One case on this rank: the first step's gradients gathered whole,
    the 3 steps' losses."""
    arch, over, shape, micro, _ = CASES[name]
    cfg = _cfg(arch, over)
    model = Model(cfg)
    mesh = make_elastic_mesh(shape[1])
    assert tuple(mesh.shape) == shape
    rules = _rules(cfg, mesh, STRATEGY.get(name, "baseline"))
    step = make_train_step(model, _opt(), microbatches=micro)
    with use_mesh_rules(mesh, rules):
        specs = train_state_specs(model)
        params = shard_tree(params_from_numpy(inputs["weights"][name], cfg,
                                              "cpu"), specs.params)
        state = TrainState(params, _opt().init(params))
        _, _, flat = step_grads(model, state.params, batch_to_device(
            inputs["batches"][name][0], "cpu"), micro, specs.params)
        grads = gather_tree(unflatten_like(state.params, flat),
                            specs.params)
        losses = []
        for b in inputs["batches"][name]:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    return {"losses": losses, "grads": grads}


def _elastic(inputs, workdir, rank):
    """One step on (2, 2), a checkpoint (and rank 0's one-rank save of the
    gathered state), then a restore onto (1, 2) over ranks 0 and 1 and a
    second step there."""
    cfg = get_config(ELASTIC).reduced()
    model = Model(cfg)
    batches = inputs["batches"]["elastic"]
    step = make_train_step(model, _opt())
    mesh = make_elastic_mesh(2)
    with use_mesh_rules(mesh, arch_rules(cfg, mesh, ("data",))):
        specs = train_state_specs(model)
        params = shard_tree(params_from_numpy(inputs["weights"]["elastic"],
                                              cfg, "cpu"), specs.params)
        state, m = step(TrainState(params, _opt().init(params)), batches[0])
        save(os.path.join(workdir, "ckpt_mesh"), 1, state, specs=specs)
        whole = gather_tree(state, specs)
    if rank == 0:
        save(os.path.join(workdir, "ckpt_one"), 1, whole)
    dist.barrier()
    small = make_elastic_mesh(2, ranks=[0, 1])
    out = {"loss_2x2": float(m["loss"])}
    if rank < 2:
        with use_mesh_rules(small, arch_rules(cfg, small, ("data",))):
            specs = train_state_specs(model)
            restored, at, _ = restore(os.path.join(workdir, "ckpt_mesh"),
                                      whole, specs=specs)
            out["blocks_equal"] = all(
                torch.equal(a, local_block(b, s)) for a, b, s in zip(
                    leaves(restored), leaves(whole),
                    spec_leaves(specs)))
            state, m = step(restored, batches[1])
            out.update(step=at, loss=float(m["loss"]),
                       params=gather_tree(state.params, specs.params))
    dist.barrier()
    return out


def _reshard(inputs, workdir, rank):
    """``RESHARD``'s train state after one step under the first layout,
    saved; restored under the second, saved again; restored under the
    first. Returns whether each restore holds the rank's blocks of the
    whole state bit for bit (rank 0 also writes the whole state one rank
    would save)."""
    arch, layouts = RESHARD
    cfg = _cfg(arch, {"capacity_factor": 4.0})
    model = Model(cfg)
    weights = inputs["weights"]["reshard"]
    out = {}
    for i, (strategy, shape) in enumerate(layouts + layouts[:1]):
        mesh = make_elastic_mesh(shape[1])
        with use_mesh_rules(mesh, _rules(cfg, mesh, strategy)):
            specs = train_state_specs(model)
            if i == 0:
                params = shard_tree(params_from_numpy(weights, cfg, "cpu"),
                                    specs.params)
                state, _ = make_train_step(model, _opt())(
                    TrainState(params, _opt().init(params)),
                    inputs["batches"]["reshard"][0])
                whole = gather_tree(state, specs)
            else:
                state, at, _ = restore(os.path.join(
                    workdir, f"ckpt_reshard{i - 1}"), whole, specs=specs)
                out[f"blocks_equal{i}"] = at == 1 and all(
                    torch.equal(a, local_block(b, s)) for a, b, s in zip(
                        leaves(state), leaves(whole), spec_leaves(specs)))
            if i < 2:
                save(os.path.join(workdir, f"ckpt_reshard{i}"), 1, state,
                     specs=specs)
    dist.barrier()
    return out


def _roundtrips():
    """``shard_tree`` then ``gather_tree`` of every config's reduced
    parameters (and one optimizer state) under each mesh's
    ``arch_rules``: equal bit for bit, each block its spec's share."""
    ok = {}
    for shape in ((2, 2), (1, 4), (4, 1)):
        mesh = make_elastic_mesh(shape[1])
        for name in list_configs():
            cfg = get_config(name).reduced()
            model = Model(cfg)
            full = model.init(torch.Generator().manual_seed(1), device="cpu")
            tree = (TrainState(full, _opt().init(full)) if name == ELASTIC
                    else full)
            with use_mesh_rules(mesh, arch_rules(cfg, mesh, ("data",))):
                specs = (train_state_specs(model) if name == ELASTIC
                         else model.param_specs())
                blocks = shard_tree(tree, specs)
                back = gather_tree(blocks, specs)
            shares = all(
                b.numel() * _ways(mesh, s) == f.numel()
                for b, f, s in zip(leaves(blocks), leaves(tree),
                                   spec_leaves(specs)))
            ok[shape, name] = shares and all(
                torch.equal(a, b) for a, b in zip(leaves(back),
                                                  leaves(tree)))
    return ok


def _ways(mesh, spec):
    """The number of blocks ``spec`` splits a tensor into on ``mesh``."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for e in spec for a in spec_axes(e))


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _launcher(workdir):
    from repro_torch.launch import train as launch_train

    handler = _Lines()
    logger = logging.getLogger("repro_torch.launch.train")
    logger.addHandler(handler)
    try:
        res = launch_train.main([
            "--arch", "llama3-8b", "--reduced", "--model-parallel", "2",
            "--steps", "30", "--batch", "8", "--seq", "16", "--device",
            "cpu", "--ckpt-dir", os.path.join(workdir, "launch")])
        mamba = launch_train.main([
            "--arch", "falcon-mamba-7b", "--reduced", "--model-parallel",
            "2", "--steps", "20", "--batch", "8", "--seq", "16",
            "--device", "cpu", "--ckpt-dir",
            os.path.join(workdir, "launch_mamba")])
    finally:
        logger.removeHandler(handler)
    return {"lines": handler.lines, "final_step": res.final_step,
            "losses": [h["loss"] for h in res.metrics_history],
            "mamba_final_step": mamba.final_step,
            "mamba_losses": [h["loss"] for h in mamba.metrics_history]}


def _worker(rank, world, init, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    res = {name: _case(name, inputs) for name in CASES}
    res["elastic"] = _elastic(inputs, workdir, rank)
    res["reshard"] = _reshard(inputs, workdir, rank)
    res["roundtrips"] = _roundtrips()
    res["launcher"] = _launcher(workdir)
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference, four host devices
# ---------------------------------------------------------------------------

REFERENCE = """
import os, json
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
assert jax.device_count() == 4
from repro.configs import get_config
from repro.launch.dryrun import arch_rules, combined_strategy_rules
from repro.models.model import Model
from repro.optim.adamw import make_optimizer
from repro.parallel.sharding import use_mesh_rules
from repro.train.steps import TrainState, make_train_step

work = {work!r}
cases = json.load(open(os.path.join(work, "cases.json")))
out = {{}}
for name, (arch, over, shape, micro, _, strategy) in cases.items():
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    z = np.load(os.path.join(work, name + ".npz"))
    params = {{}}
    for key in z.files:
        if key.startswith("batch"):
            continue
        node = params
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {{}})
        node[leaf] = jnp.asarray(z[key])
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    opt = make_optimizer(base_lr=1e-3, warmup=1, total=10)
    rules = arch_rules(cfg, mesh, ("data",))
    rules.update(combined_strategy_rules(strategy, cfg, mesh, None))
    with use_mesh_rules(mesh, rules), mesh:
        state = TrainState(params=params, opt=opt.init(params))
        step = jax.jit(make_train_step(Model(cfg), opt, microbatches=micro))
        losses = []
        for t in range({steps}):
            b = {{k.split("/")[1]: jnp.asarray(z[k]) for k in z.files
                 if k.startswith(f"batch{{t}}/")}}
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    out[name] = losses
json.dump(out, open(os.path.join(work, "reference.json"), "w"))
"""


def _flat_numpy(tree):
    return {k: np.asarray(v) for k, v in leaves_with_paths(tree)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's losses, both started
    at once: ({rank: results}, {case: losses})."""
    work = tmp_path_factory.mktemp("spmd")
    inputs = {"weights": {}, "batches": {}}
    for name, (arch, over, _, _, masked) in CASES.items():
        inputs["weights"][name] = _weights(arch, over)
        inputs["batches"][name] = _batches(_cfg(arch, over), masked)
        arrays = _flat_numpy(inputs["weights"][name])
        for t, b in enumerate(inputs["batches"][name]):
            arrays.update({f"batch{t}/{k}": v for k, v in b.items()})
        np.savez(work / f"{name}.npz", **arrays)
    inputs["weights"]["elastic"] = _weights(ELASTIC, {}, seed=3)
    inputs["batches"]["elastic"] = _batches(
        get_config(ELASTIC).reduced(), False)
    inputs["weights"]["reshard"] = _weights(RESHARD[0], {}, seed=4)
    inputs["batches"]["reshard"] = _batches(
        get_config(RESHARD[0]).reduced(), False)
    torch.save(inputs, work / "inputs.pt")
    (work / "cases.json").write_text(json.dumps(
        {name: (*CASES[name], STRATEGY.get(name, "baseline"))
         for name in set(REFERENCE_RUN.values())}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    init = f"file://{work / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), init, str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(
            work=str(work), steps=STEPS))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode()
            for p in procs + [ref]]
    assert all(p.returncode == 0 for p in procs + [ref]), logs
    ranks = {r: torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)}
    return ranks, json.loads((work / "reference.json").read_text()), work


@pytest.fixture(autouse=True)
def _one_thread():
    """This module's one-rank runs on one intra-op thread, as its ranks
    run: beside the module's own rank and reference processes (and the
    suite's other workers), more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _one_rank(name):
    """The port on one process (no mesh, so under no strategy): the first
    step's gradients and the 3 steps' losses."""
    arch, over, _, micro, masked = CASES[name]
    cfg = _cfg(arch, over)
    model = Model(cfg)
    params = params_from_numpy(_weights(arch, over), cfg, "cpu")
    batches = _batches(cfg, masked)
    _, _, flat = step_grads(model, params, batch_to_device(batches[0],
                                                           "cpu"), micro)
    grads = unflatten_like(params, flat)
    step = make_train_step(model, _opt(), microbatches=micro)
    state = TrainState(params, _opt().init(params))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return grads, losses


def _grads_close(got, want):
    for (path, g), w in zip(leaves_with_paths(got), leaves(want)):
        scale = float(w.abs().max())
        err = float((g.detach() - w).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (path, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_spmd_step_matches_reference_and_one_rank(runs, name):
    """The port's 3 losses on the case's mesh: the same on every rank,
    within ``LOSS_RTOL`` of the reference's 4-device GSPMD run and of the
    port on one rank; the first step's gradients within ``GRAD_TOL`` of
    the one-rank ones."""
    ranks, reference, _ = runs
    losses = [ranks[r][name]["losses"] for r in range(WORLD)]
    assert all(ls == losses[0] for ls in losses), losses
    np.testing.assert_allclose(losses[0], reference[REFERENCE_RUN[name]],
                               rtol=LOSS_RTOL)
    grads, one = _one_rank(name)
    np.testing.assert_allclose(losses[0], one, rtol=LOSS_RTOL)
    for r in range(WORLD):
        _grads_close(ranks[r][name]["grads"], grads)


def test_masked_labels_give_the_global_mean(runs):
    """Ranks whose rows hold 48 and 8 masked labels: the first loss is the
    global token mean (the reference's), which the mean of the two data
    ranks' own means (the one-rank loss of each half of the batch) would
    miss by more than twice the bar."""
    ranks, reference, _ = runs
    got = ranks[0]["masked_2x2"]["losses"]
    np.testing.assert_allclose(got, reference["masked_2x2"], rtol=LOSS_RTOL)
    arch, over, _, _, _ = CASES["masked_2x2"]
    cfg = _cfg(arch, over)
    model = Model(cfg)
    params = params_from_numpy(_weights(arch, over), cfg, "cpu")
    batch = batch_to_device(_batches(cfg, True)[0], "cpu")
    with torch.no_grad():
        halves = [float(model.loss(params, {k: v.chunk(2)[i] for k, v in
                                            batch.items()})[0])
                  for i in range(2)]
    assert abs(sum(halves) / 2 - got[0]) > 2 * LOSS_RTOL * got[0], (
        halves, got[0])


def test_elastic_restore_onto_fewer_ranks(runs):
    """The counterpart of ``test_elastic_mesh_shrink_and_restore``: the
    checkpoint written on (2, 2) holds the arrays of a one-rank save of
    the gathered state, bit for bit; restored onto (1, 2) over ranks 0
    and 1, each rank holds its blocks of it, and the next step equals a
    one-rank restore's step (loss within ``LOSS_RTOL``, parameters within
    ``GRAD_TOL`` of each leaf's largest |p|)."""
    ranks, _, work = runs
    step_dir = "step_0000000001"
    with np.load(work / "ckpt_mesh" / step_dir / "arrays.npz") as a, \
            np.load(work / "ckpt_one" / step_dir / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    cfg = get_config(ELASTIC).reduced()
    model = Model(cfg)
    like = TrainState(params_from_numpy(_weights(ELASTIC, {}, seed=3), cfg,
                                        "cpu"), None)
    like = TrainState(like.params, _opt().init(like.params))
    state, at, _ = restore(str(work / "ckpt_mesh"), like)
    state, m = make_train_step(model, _opt())(
        state, _batches(cfg, False)[1])
    for r in (0, 1):
        e = ranks[r]["elastic"]
        assert e["step"] == at == 1 and e["blocks_equal"]
        np.testing.assert_allclose(e["loss"], float(m["loss"]),
                                   rtol=LOSS_RTOL)
        _grads_close(e["params"], state.params)
    assert all("loss" not in ranks[r]["elastic"] for r in (2, 3))


def test_launcher_trains_llama_and_falcon_mamba_on_four_ranks(runs):
    """``launch.train --reduced --model-parallel 2`` in the four-rank
    group: the mesh (2, 2), llama3-8b for 30 steps and falcon-mamba-7b
    (its mixer on 64 of 128 channels a rank) for 20, each with the same
    falling losses on every rank."""
    ranks, _, _ = runs
    launch = ranks[0]["launcher"]
    assert "mesh {'data': 2, 'model': 2} over 4 ranks" in launch["lines"]
    assert launch["final_step"] == 30 and launch["mamba_final_step"] == 20
    for key, n in (("losses", 3), ("mamba_losses", 2)):
        losses = launch[key]
        assert len(losses) == n and all(np.isfinite(losses))
        assert losses[-1] < losses[0], losses
        for r in range(WORLD):
            assert ranks[r]["launcher"][key] == losses


def test_checkpoint_reshards_between_baseline_and_ep(runs):
    """``RESHARD``: one step under the baseline rules on (2, 2), a
    checkpoint, restored under ``ep`` on (1, 4) (each rank now holds 1 of
    the 4 experts whole, the dense weights as the baseline splits them)
    and saved again, then restored under the baseline on (2, 2): each
    restore holds the rank's blocks of the state, and the two
    checkpoints hold the same arrays, bit for bit."""
    ranks, _, work = runs
    for r in range(WORLD):
        assert ranks[r]["reshard"] == {"blocks_equal1": True,
                                       "blocks_equal2": True}
    step_dir = "step_0000000001"
    with np.load(work / "ckpt_reshard0" / step_dir / "arrays.npz") as a, \
            np.load(work / "ckpt_reshard1" / step_dir / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_shard_and_gather_round_trip_every_config(runs, shape):
    ranks, _, _ = runs
    for r in range(WORLD):
        trips = {k[1]: v for k, v in ranks[r]["roundtrips"].items()
                 if k[0] == shape}
        assert set(trips) == set(list_configs()) and all(trips.values()), \
            trips


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
