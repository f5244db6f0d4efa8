"""The port's mamba and hybrid training, and its prefill and decode, over
a multi-rank mesh on the CPU, against the JAX package's GSPMD runs and
against the port on one rank.

Four ``gloo`` ranks, started once for the module (this file run as four
processes, ``__main__`` -> ``_worker``, a ``file://`` store under the
pytest tmp dir), and the reference in two subprocesses with four forced host
devices each (``XLA_FLAGS`` set before JAX starts, as in
``tests/test_multidevice.py``; jamba's train step in one, the rest in
the other), all running at once. The weights are
the port's seeded ``Model.init`` on the CPU, handed to both sides as
numpy (the ranks take them through ``params_from_numpy`` and keep their
blocks, ``shard_tree``); every input is a seeded numpy array, the same on
both sides. Everything runs under ``launch.dryrun.arch_rules`` of the
mesh, on both sides. The reduced jamba-v0.1-52b takes a capacity factor
of 4 (= its experts), so that no token is dropped whether the tokens are
dispatched all at once or a data rank's at a time, and the one-rank runs
are the same function.

  * Training (``TRAIN_CASES``): reduced falcon-mamba-7b and jamba on
    (2, 2) and (1, 4) (d_inner 128: 64 or 32 channels a rank; on (2, 2)
    the ``in_proj`` blocks must be exchanged, on (1, 4) too, and
    jamba's 2 kv heads do not divide the model axis of 4), 3 steps of
    ``make_optimizer(base_lr=1e-3, warmup=1, total=10)``: the losses
    within rtol 2e-3 of the reference's 4-device run (one run a config,
    on (2, 2): GSPMD computes the same step on any mesh) and of the port
    on one rank; the first step's gradients, gathered, within 1e-5 of
    each leaf's largest |g| of the one-rank port.
  * Prefill and decode (``INFER_CASES``): reduced llama3-8b, h2o-danube
    -1.8b (window 32: the ring buffer of 32 positions, 8 or 16 a rank,
    wraps during the steps), qwen2-vl-2b (embeddings, M-RoPE),
    falcon-mamba-7b and jamba, each on (2, 2) and (1, 4), with a scalar
    and a per-slot ``cur_index``: a prefill of 4 x 16 and 6 decode
    steps of seeded tokens against a cache ``kv_seq``-sharded over the
    model axis (and batch-sharded over the data axis). The gathered
    float32 logits (``models.model.gather_logits``) within ``LOGIT_TOL``
    of the one-rank port and of the reference's 4-device jitted
    ``prefill`` / ``decode_step`` with the dry run's in_shardings (one
    run a config and cur mode, on (2, 2)); the gathered caches within
    ``CACHE_TOL`` of the one-rank port's.
  * The strategies of ``launch.dryrun.strategy_rules`` on top of
    ``arch_rules``, on both sides (``STRATEGY_TRAIN``,
    ``STRATEGY_INFER``): ``seqpar`` training of falcon-mamba-7b and
    jamba on (2, 2) and (1, 4), jamba's (1, 4) run at a capacity factor
    of 1.0, so that tokens are dropped and the mesh must drop the same
    ones (its dispatch runs on the data shard's whole sequence, gathered
    before the router); ``"seqpar,ep"`` jamba training on (1, 4); the
    prefill and the slot mode's 6 decode steps of llama3-8b and
    qwen2-vl-2b under ``seqpar`` (decode reads no "seq" rule), of grok-1
    and llama4-scout (capacity factor 4) under ``ep``, and of jamba
    under ``"seqpar,ep"``, each on (2, 2) and (1, 4). The same bars as
    the baseline's, against the reference's run under the same rules
    (one run a config and strategy) and the one-rank port.
  * int8 (``INT8_MESHES``): reduced llama3-8b on (2, 2) and (1, 4),
    ``quantize_params`` of the rank's blocks equal, bit for bit, to the
    blocks of the one-rank tree (``quantized_specs``); every
    row-parallel linear's output (attention's and the MLP's ``wo``: K5's
    int32 blocks summed over the model group, then the one rescale)
    equal, bit for bit, to the rank's rows of one rank's linear on the
    gathered input and weights; the float32 prefill logits within
    ``INT8_PREFILL_TOL`` (1e-6) of the one-rank int8 logits' largest
    |logit|, with top-1 equal everywhere, its 6 decode steps within
    ``INT8_TOL``; and every K5 call's int8 codes equal to the rank's
    block of the one-rank call's (the activation scale taken over the
    batch and, for a row-parallel linear, the model group).
  * The int8 decode's drift from one rank (``INT8_DRIFT``): a reduced
    llama3-8b wide enough that codes flip, ``DRIFT_STEPS`` int8 decode
    steps on ``DRIFT_MESH``, each from one rank's cache, beside one
    rank's step, on both sides: the reference's jitted 4-device step
    against its jitted step on one device (a fifth reference process),
    the port's four ranks against the port on one rank. The partial
    softmax sums of the split cache add in another order than one
    rank's, and a code at a rounding boundary flips, on both sides.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.pytree import leaves, leaves_with_paths, unflatten_like
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import (arch_rules, batch_logical_axes,
                                      combined_strategy_rules)
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models.model import Model, gather_logits, params_from_numpy
from repro_torch.optim.adamw import make_optimizer
from repro_torch.parallel.sharding import (gather_tree, logical_group,
                                           quantized_specs, shard_tree,
                                           use_mesh_rules)
from repro_torch.train.steps import (TrainState, batch_to_device,
                                     make_train_step, step_grads,
                                     train_state_specs)
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TRAIN_BATCH, TRAIN_SEQ, STEPS = 8, 16, 3
B, SEQ, DECODE_STEPS, MAX_LEN = 4, 16, 6, 16
#: the first decode position of each cur mode; the window config starts
#: near its 32 positions, so the ring wraps during the steps
CUR0 = {"scalar": 3, "slots": [0, 2, 5, 9]}
CUR0_WINDOW = {"scalar": 29, "slots": [26, 28, 29, 31]}
#: the reference's bar between its SPMD step and one device
LOSS_RTOL = 2e-3
#: of each leaf's largest |g|: float32 sums in another order. Reduced
#: jamba's 8 sublayers amplify one ulp of noise in each linear's output
#: to up to 6.6e-6 of a leaf's largest |g| on one rank alone (and its
#: caches' to 2.2e-6), where falcon-mamba's move by 1.1e-6
#: (``test_jamba_float32_noise_floor``); the mesh's row-parallel partial
#: sums add such noise, so jamba's bars are three times its floor
GRAD_TOL = {"falcon-mamba-7b": 1e-5, "jamba-v0.1-52b": 2e-5}
#: float32 logits: absolute
LOGIT_TOL = 1e-4
#: the caches against one rank's: of each leaf's largest |value|
CACHE_TOL = {"jamba-v0.1-52b": 6e-6}
CACHE_TOL_DEFAULT = 1e-6
#: one ulp of float32, the relative noise ``_one_ulp_noise`` puts on
#: every linear's output
ULP = 2.0 ** -23
#: the int8 decode logits: of the one-rank int8 logits' largest |logit|
INT8_TOL = 1e-4
#: the int8 prefill logits: the row-parallel outputs are one rank's bit
#: for bit, so only the float32 rounding of other sums is left
INT8_PREFILL_TOL = 1e-6
WORKER_TIMEOUT_S = 300
JAMBA = {"capacity_factor": 4.0}
#: a capacity factor at which reduced jamba's experts drop tokens
JAMBA_DROPS = {"capacity_factor": 1.0}
#: name -> (arch, config fields replaced, mesh, strategy)
TRAIN_CASES = {
    "mamba_2x2": ("falcon-mamba-7b", {}, (2, 2), "baseline"),
    "mamba_1x4": ("falcon-mamba-7b", {}, (1, 4), "baseline"),
    "jamba_2x2": ("jamba-v0.1-52b", JAMBA, (2, 2), "baseline"),
    "jamba_1x4": ("jamba-v0.1-52b", JAMBA, (1, 4), "baseline"),
    "mamba_seqpar_2x2": ("falcon-mamba-7b", {}, (2, 2), "seqpar"),
    "mamba_seqpar_1x4": ("falcon-mamba-7b", {}, (1, 4), "seqpar"),
    "jamba_seqpar_2x2": ("jamba-v0.1-52b", JAMBA, (2, 2), "seqpar"),
    "jamba_seqpar_drops_1x4": ("jamba-v0.1-52b", JAMBA_DROPS, (1, 4),
                               "seqpar"),
    "jamba_seqpar_ep_1x4": ("jamba-v0.1-52b", JAMBA, (1, 4), "seqpar,ep"),
}
INFER_MODELS = {
    "llama": ("llama3-8b", {}),
    "danube": ("h2o-danube-1.8b", {}),
    "qwen2vl": ("qwen2-vl-2b", {}),
    "mamba": ("falcon-mamba-7b", {}),
    "jamba": ("jamba-v0.1-52b", JAMBA),
    "grok": ("grok-1-314b", {"capacity_factor": 4.0}),
    "scout": ("llama4-scout-17b-16e", {"capacity_factor": 4.0}),
}
MESHES = ((2, 2), (1, 4))
CUR_MODES = ("scalar", "slots")
#: (model, strategy) -> the cur modes it runs
INFER_RUNS = {(m, "baseline"): CUR_MODES
              for m in ("llama", "danube", "qwen2vl", "mamba", "jamba")}
INFER_RUNS.update({("llama", "seqpar"): ("slots",),
                   ("qwen2vl", "seqpar"): ("slots",),
                   ("grok", "ep"): ("slots",),
                   ("scout", "ep"): ("slots",),
                   ("jamba", "seqpar,ep"): ("slots",)})
INFER_CASES = [(m, st, shape, cur) for (m, st), modes in INFER_RUNS.items()
               for shape in MESHES for cur in modes]
INT8 = "llama3-8b"
INT8_MESHES = ((2, 2), (1, 4))
#: the drift case's widths: 4 x 256 attention outputs a layer and step
#: are quantized for ``wo``, so that some codes sit within a rounding of
#: a boundary (at the reduced widths none does over 6 steps)
INT8_DRIFT = {"d_model": 256, "n_layers": 2, "d_ff": 512, "n_heads": 8,
              "n_kv_heads": 4, "head_dim": 32}
DRIFT_STEPS, DRIFT_LEN, DRIFT_MESH = 96, 128, (1, 4)


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch).reduced(), **over)


def _numpy_tree(tree):
    return {k: (_numpy_tree(v) if isinstance(v, dict) else v.numpy())
            for k, v in tree.items()}


def _weights(arch, over, seed=0):
    model = Model(_cfg(arch, over))
    return _numpy_tree(model.init(torch.Generator().manual_seed(seed),
                                  device="cpu"))


def _opt():
    return make_optimizer(base_lr=1e-3, warmup=1, total=10)


def _train_batches(cfg):
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_SEQ)
    return [data.batch(t, TRAIN_BATCH) for t in range(STEPS)]


def _infer_inputs(cfg, seed=0):
    """{"prefill": the prefill's batch, "tokens": the decode steps'
    (B, 1) tokens or (B, 1, d) embeddings, "cur": {mode: [the steps'
    cur_index]}}, numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        prefill = {"tokens": rng.integers(0, cfg.vocab, (B, SEQ)).astype(
            np.int32)}
        tokens = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
                  for _ in range(DECODE_STEPS)]
    else:
        prefill = {"embeds": rng.standard_normal((B, SEQ, cfg.d_model),
                                                 dtype=np.float32)}
        if cfg.mrope:
            t = np.arange(SEQ, dtype=np.int32)
            prefill["positions"] = np.stack(
                [np.broadcast_to(t, (B, SEQ)),
                 np.broadcast_to(t // 4, (B, SEQ)),
                 np.broadcast_to(t % 4, (B, SEQ))]).astype(np.int32)
        tokens = [rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
                  for _ in range(DECODE_STEPS)]
    start = CUR0_WINDOW if cfg.window > 0 else CUR0
    cur = {"scalar": [start["scalar"] + t for t in range(DECODE_STEPS)],
           "slots": [np.asarray(start["slots"], np.int32) + t
                     for t in range(DECODE_STEPS)]}
    return {"prefill": prefill, "tokens": tokens, "cur": cur}


def _max_len(cfg):
    """The caches' length: the window for the ring buffer's config."""
    return cfg.window if cfg.window > 0 else MAX_LEN


def _cur(c):
    return int(c) if np.ndim(c) == 0 else torch.as_tensor(c)


def _decode(model, params, inputs, mode, device="cpu"):
    """The decode steps from zeroed caches: (every step's logits, the
    caches), the logits and caches of the rank under a mesh."""
    cfg = model.cfg
    caches = model.cache_init(B, _max_len(cfg), device=device)
    out = []
    for tok, cur in zip(inputs["tokens"], inputs["cur"][mode]):
        logits, caches = model.decode_step(params, caches,
                                           torch.as_tensor(tok), _cur(cur))
        out.append(logits)
    return out, caches


# ---------------------------------------------------------------------------
# the four ranks
# ---------------------------------------------------------------------------

def _mesh(cfg, shape, batch, strategy="baseline"):
    mesh = make_elastic_mesh(shape[1])
    assert tuple(mesh.shape) == shape
    rules = arch_rules(cfg, mesh, batch_logical_axes(batch, mesh))
    rules.update(combined_strategy_rules(strategy, cfg, mesh, None))
    return mesh, rules


def _ref_key(arch, over, strategy):
    """The name of the reference's run of a config under a strategy."""
    return json.dumps([arch, over, strategy], sort_keys=True)


def _train_case(name, inputs):
    arch, over, shape, strategy = TRAIN_CASES[name]
    cfg = _cfg(arch, over)
    model = Model(cfg)
    mesh, rules = _mesh(cfg, shape, TRAIN_BATCH, strategy)
    step = make_train_step(model, _opt())
    batches = inputs["train"][arch]
    with use_mesh_rules(mesh, rules):
        specs = train_state_specs(model)
        params = shard_tree(params_from_numpy(inputs["weights"][arch], cfg,
                                              "cpu"), specs.params)
        state = TrainState(params, _opt().init(params))
        _, _, flat = step_grads(model, state.params, batch_to_device(
            batches[0], "cpu"), 1, specs.params)
        grads = gather_tree(unflatten_like(state.params, flat), specs.params)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
    return {"losses": losses, "grads": grads}


def _infer_case(key, strategy, inputs):
    """A prefill and each cur mode's decode steps on each mesh under the
    strategy: the gathered logits and caches."""
    arch, over = INFER_MODELS[key]
    cfg = _cfg(arch, over)
    model = Model(cfg)
    out = {}
    for shape in MESHES:
        mesh, rules = _mesh(cfg, shape, B, strategy)
        with use_mesh_rules(mesh, rules):
            params = shard_tree(params_from_numpy(
                inputs["weights"][arch], cfg, "cpu"), model.param_specs())
            x = inputs["infer"][arch]
            pre = gather_logits(model.prefill(params, batch_to_device(
                x["prefill"], "cpu")))
            for mode in INFER_RUNS[key, strategy]:
                steps, caches = _decode(model, params, x, mode)
                out[key, strategy, shape, mode] = {
                    "prefill": pre,
                    "decode": [gather_logits(s) for s in steps],
                    "caches": gather_tree(caches, model.cache_specs())}
    return out


class _Codes:
    """Keeps the int8 codes of every K5 call (``ops.qmatmul``)."""

    def __init__(self):
        self.codes, self._real = [], ops.qmatmul

    def __enter__(self):
        def wrapped(x, w, scale, *a, **kw):
            self.codes.append(x.clone())
            return self._real(x, w, scale, *a, **kw)
        ops.qmatmul = wrapped
        return self

    def __exit__(self, *exc):
        ops.qmatmul = self._real


def _gather_dim(x, group, dim):
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _RowParallel:
    """Wraps ``layers.row_parallel_linear`` (and the names ``attention``
    and ``ssm`` import) under a mesh: each call also gathers its input
    (the batch's rows, the contraction axis's blocks) and its weights
    whole, runs one rank's linear on them (no mesh) and keeps whether the
    rank's output is that output's block of rows, bit for bit."""

    def __init__(self):
        from repro_torch.models import attention, layers, ssm
        self.modules = (layers, attention, ssm)
        self.real = layers.row_parallel_linear
        self.equal = []

    def __enter__(self):
        real, equal = self.real, self.equal

        def wrapped(cfg, p, x, name, seq=None):
            y = real(cfg, p, x, name, seq)
            tp, batch = logical_group(name), logical_group("batch")
            fsdp = logical_group("fsdp")
            xs = _gather_dim(_gather_dim(x, tp, -1), batch, 0)
            whole = {"w_int": _gather_dim(_gather_dim(p["w_int"], tp, 0),
                                          fsdp, 1),
                     "w_scale": _gather_dim(p["w_scale"], fsdp, 1)}
            with use_mesh_rules(None):
                want = real(cfg, whole, xs, name)
            rows = want.shape[0] // (1 if batch is None
                                     else dist.get_world_size(batch))
            r = 0 if batch is None else dist.get_rank(batch)
            equal.append(y.dtype == want.dtype and torch.equal(
                y, want[r * rows:(r + 1) * rows]))
            return y

        for m in self.modules:
            m.row_parallel_linear = wrapped
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.row_parallel_linear = self.real


def _int8_case(inputs, shape):
    arch = INT8
    cfg = _cfg(arch, {})
    model = Model(cfg)
    full = params_from_numpy(inputs["weights"][arch], cfg, "cpu")
    mesh, rules = _mesh(cfg, shape, B)
    x = inputs["infer"][arch]
    with use_mesh_rules(mesh, rules):
        pspecs = model.param_specs()
        q = model.quantize_params(shard_tree(full, pspecs))
        whole = model.quantize_params(full)
        blocks_equal = all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                leaves(q), leaves(shard_tree(whole, quantized_specs(
                    whole, pspecs)))))
        with _Codes() as codes:
            pre = gather_logits(model.prefill(q, batch_to_device(
                x["prefill"], "cpu")))
            steps, _ = _decode(model, q, x, "slots")
        steps = [gather_logits(s) for s in steps]
        with _RowParallel() as rows:
            model.prefill(q, batch_to_device(x["prefill"], "cpu"))
    return {"blocks_equal": blocks_equal, "prefill": pre, "decode": steps,
            "codes": codes.codes, "row_parallel_equal": rows.equal,
            "coords": [mesh.get_local_rank("data"),
                       mesh.get_local_rank("model")]}


def _drift_inputs(seed=0):
    """The drift case's weights and steps (tokens, per-slot cur), numpy."""
    rng = np.random.default_rng(seed)
    cfg = _cfg(INT8, INT8_DRIFT)
    return {"weights": _weights(INT8, INT8_DRIFT),
            "tokens": [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
                       for _ in range(DRIFT_STEPS)],
            "cur": [np.asarray(CUR0["slots"], np.int32) + t
                    for t in range(DRIFT_STEPS)]}


def _int8_drift_case(inputs):
    """Each int8 decode step on ``DRIFT_MESH`` from one rank's cache (its
    blocks), beside one rank's step: the gathered logits' max |diff| over
    one rank's largest |logit|, a step."""
    cfg = _cfg(INT8, INT8_DRIFT)
    model = Model(cfg)
    x = inputs["drift"]
    full = params_from_numpy(x["weights"], cfg, "cpu")
    one = model.quantize_params(full)
    mesh, rules = _mesh(cfg, DRIFT_MESH, B)
    with use_mesh_rules(mesh, rules):
        q = model.quantize_params(shard_tree(full, model.param_specs()))
    cache = model.cache_init(B, DRIFT_LEN, device="cpu")
    drift = []
    for tok, cur in zip(x["tokens"], x["cur"]):
        tok, cur = torch.as_tensor(tok), torch.as_tensor(cur)
        with use_mesh_rules(mesh, rules):
            got, _ = model.decode_step(
                q, shard_tree(cache, model.cache_specs()), tok, cur)
            got = gather_logits(got)
        want, cache = model.decode_step(one, cache, tok, cur)
        drift.append(float((got - want).abs().max() / want.abs().max()))
    return drift


def _worker(rank, world, init, workdir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    res = {"train": {name: _train_case(name, inputs)
                     for name in TRAIN_CASES}, "infer": {}}
    for key, strategy in INFER_RUNS:
        res["infer"].update(_infer_case(key, strategy, inputs))
    res["int8"] = {shape: _int8_case(inputs, shape) for shape in INT8_MESHES}
    res["int8_drift"] = _int8_drift_case(inputs)
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
assert jax.device_count() == 4
from repro.configs import get_config
from repro.launch.dryrun import (_quantized_specs, arch_rules,
                                  combined_strategy_rules)
from repro.models.model import Model
from repro.optim.adamw import make_optimizer
from repro.parallel.sharding import use_mesh_rules
from repro.train.steps import TrainState, make_train_step

work, part = {work!r}, {part!r}
spec = json.load(open(os.path.join(work, part + "_cases.json")))
meshes = {{shape: Mesh(np.array(jax.devices()).reshape(shape),
                      ("data", "model")) for shape in ((2, 2), (1, 4))}}
mesh = meshes[2, 2]


def load(name):
    z = np.load(os.path.join(work, name + ".npz"))
    tree = {{}}
    for key in z.files:
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {{}})
        node[leaf] = jnp.asarray(z[key])
    return tree


def named(tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


def rules(cfg, strategy, mesh=mesh):
    r = arch_rules(cfg, mesh, ("data",))
    r.update(combined_strategy_rules(strategy, cfg, mesh, None))
    return r


out = {{"train": {{}}, "infer": {{}}}}
for key, arch, over, strategy, shape in spec["train"]:
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    params = load("weights_" + arch)
    batches = load("train_" + arch)
    opt = make_optimizer(base_lr=1e-3, warmup=1, total=10)
    m = meshes[tuple(shape)]
    with use_mesh_rules(m, rules(cfg, strategy, m)), m:
        state = TrainState(params=params, opt=opt.init(params))
        step = jax.jit(make_train_step(Model(cfg), opt))
        losses = []
        for t in range({steps}):
            state, m = step(state, batches[str(t)])
            losses.append(float(m["loss"]))
    out["train"][key] = losses

for key, arch, over, strategy, max_len, modes in spec["infer"]:
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = Model(cfg)
    params = load("weights_" + arch)
    x = load("infer_" + arch)
    res = {{}}
    with use_mesh_rules(mesh, rules(cfg, strategy)), mesh:
        psh = named(model.param_specs())
        bspec = {{"tokens": P("data", None), "embeds": P("data", None, None),
                 "positions": P(None, "data", None)}}
        batch = x["prefill"]
        prefill = jax.jit(model.prefill, in_shardings=(
            psh, {{k: NamedSharding(mesh, bspec[k]) for k in batch}}))
        res["prefill"] = np.asarray(prefill(params, batch)).tolist()
        tok_sh = NamedSharding(mesh, P("data", None) if cfg.embed_inputs
                               else P("data", None, None))
        csh = named(model.cache_specs())
        decode = jax.jit(model.decode_step, in_shardings=(
            psh, csh, tok_sh, NamedSharding(mesh, P())))
        for mode in modes:
            cache = model.cache_init({batch}, max_len)
            steps = []
            for t in range({decode_steps}):
                cur = x["cur_" + mode][str(t)]
                logits, cache = decode(params, cache, x["tokens"][str(t)],
                                       cur)
                steps.append(np.asarray(logits).tolist())
            res[mode] = steps
    out["infer"][key] = res

if spec.get("drift"):
    # each int8 step on the mesh from the one-device cache, beside the
    # jitted step on one device (outside the mesh's rules)
    arch, over, shape, max_len = spec["drift"]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = Model(cfg)
    q = model.quantize_params(load("weights_drift"))
    x = load("drift")
    m = meshes[tuple(shape)]
    with use_mesh_rules(m, rules(cfg, "baseline", m)), m:
        on = lambda tree: jax.tree.map(lambda s: NamedSharding(m, s), tree,
                                       is_leaf=lambda s: isinstance(s, P))
        psh = on(_quantized_specs(jax.eval_shape(lambda: q),
                                  model.param_specs()))
        csh = on(model.cache_specs())
        decode = jax.jit(model.decode_step, in_shardings=(
            psh, csh, NamedSharding(m, P("data", None)),
            NamedSharding(m, P())))
    qm = jax.device_put(q, psh)
    one = jax.jit(model.decode_step)
    cache = jax.device_put(model.cache_init({batch}, max_len),
                           jax.devices()[0])
    drift = []
    for t in range(len(x["tokens"])):
        tok, cur = x["tokens"][str(t)], x["cur"][str(t)]
        with use_mesh_rules(m, rules(cfg, "baseline", m)), m:
            got, _ = decode(qm, jax.device_put(cache, csh), tok, cur)
        want, cache = one(q, cache, tok, cur)
        got, want = np.asarray(got), np.asarray(want)
        drift.append(float(np.abs(got - want).max() / np.abs(want).max()))
    out["drift"] = drift
json.dump(out, open(os.path.join(work, part + ".json"), "w"))
"""


#: the reference's processes, run at once: jamba's train steps (each
#: compile takes long) in two, the other train steps and the strategies'
#: prefill and decode in a third, the baseline's in a fourth, the int8
#: drift case in a fifth
REFERENCE_PARTS = ("ref_jamba", "ref_jamba2", "ref_rest", "ref_infer",
                   "ref_drift")


def _reference_parts():
    """part -> {"train": [[key, arch, over, strategy, mesh]], "infer":
    [[key, arch, over, strategy, max_len, modes]]}: one run a config and
    strategy, a train run on the mesh of the config's first case (GSPMD
    computes the same step on any mesh where no token is dropped; where
    the experts drop tokens, the data axis splits the dispatch, and the
    run takes the case's mesh)."""
    train = {}
    for arch, over, shape, strategy in TRAIN_CASES.values():
        key = _ref_key(arch, over, strategy)
        train.setdefault(key, [key, arch, over, strategy, shape])
    jamba = [v for v in train.values() if v[1] == "jamba-v0.1-52b"]
    parts = {"ref_jamba": {"train": jamba[:2], "infer": []},
             "ref_jamba2": {"train": jamba[2:], "infer": []},
             "ref_rest": {"train": [v for v in train.values()
                                    if v[1] != "jamba-v0.1-52b"],
                          "infer": []},
             "ref_infer": {"train": [], "infer": []},
             "ref_drift": {"train": [], "infer": [],
                           "drift": [INT8, INT8_DRIFT, list(DRIFT_MESH),
                                     DRIFT_LEN]}}
    for (m, strategy), modes in INFER_RUNS.items():
        arch, over = INFER_MODELS[m]
        part = "ref_infer" if strategy == "baseline" else "ref_rest"
        parts[part]["infer"].append([_ref_key(arch, over, strategy), arch,
                                     over, strategy,
                                     _max_len(_cfg(arch, over)),
                                     list(modes)])
    return parts


def _flat_numpy(tree, prefix=""):
    return {prefix + k: np.asarray(v) for k, v in leaves_with_paths(tree)}


def _save(path, arrays):
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and the reference's, both started at once:
    ({rank: results}, reference, inputs). The reference runs in
    ``REFERENCE_PARTS`` processes, each with four host devices."""
    work = tmp_path_factory.mktemp("spmd_inference")
    archs = sorted({a for a, _, _, _ in TRAIN_CASES.values()}
                   | {a for a, _ in INFER_MODELS.values()})
    over = {a: o for a, o, _, _ in TRAIN_CASES.values()}
    over.update({a: o for a, o in INFER_MODELS.values()})
    inputs = {"weights": {}, "train": {}, "infer": {}}
    for arch in archs:
        cfg = _cfg(arch, over[arch])
        inputs["weights"][arch] = _weights(arch, over[arch])
        _save(work / f"weights_{arch}.npz",
              _flat_numpy(inputs["weights"][arch]))
    for arch, o, _, _ in TRAIN_CASES.values():
        inputs["train"][arch] = _train_batches(_cfg(arch, o))
        _save(work / f"train_{arch}.npz", {
            f"{t}/{k}": v for t, b in enumerate(inputs["train"][arch])
            for k, v in b.items()})
    for arch, o in INFER_MODELS.values():
        x = _infer_inputs(_cfg(arch, o))
        inputs["infer"][arch] = x
        arrays = {f"prefill/{k}": v for k, v in x["prefill"].items()}
        arrays.update({f"tokens/{t}": v for t, v in enumerate(x["tokens"])})
        for mode in CUR_MODES:
            arrays.update({f"cur_{mode}/{t}": np.asarray(v, np.int32)
                           for t, v in enumerate(x["cur"][mode])})
        _save(work / f"infer_{arch}.npz", arrays)
    inputs["drift"] = drift = _drift_inputs()
    _save(work / "weights_drift.npz", _flat_numpy(drift["weights"]))
    _save(work / "drift.npz", {
        f"{k}/{t}": v for k in ("tokens", "cur")
        for t, v in enumerate(drift[k])})
    torch.save(inputs, work / "inputs.pt")
    for part, cases in _reference_parts().items():
        (work / f"{part}_cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    init = f"file://{work / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD), init, str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    refs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE.format(
            work=str(work), part=part, steps=STEPS, batch=B,
            decode_steps=DECODE_STEPS))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for part in REFERENCE_PARTS]
    logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode()
            for p in procs + refs]
    assert all(p.returncode == 0 for p in procs + refs), logs
    ranks = {r: torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)}
    reference = {"train": {}, "infer": {}}
    for part in REFERENCE_PARTS:
        got = json.loads((work / f"{part}.json").read_text())
        for key in ("train", "infer"):
            reference[key].update(got[key])
        if "drift" in got:
            reference["drift"] = got["drift"]
    return ranks, reference, inputs


# ---------------------------------------------------------------------------
# the one-rank port
# ---------------------------------------------------------------------------

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



def _one_rank_train(arch, over, inputs):
    cfg = _cfg(arch, over)
    model = Model(cfg)
    params = params_from_numpy(inputs["weights"][arch], cfg, "cpu")
    batches = inputs["train"][arch]
    _, _, flat = step_grads(model, params, batch_to_device(batches[0],
                                                           "cpu"))
    grads = unflatten_like(params, flat)
    step = make_train_step(model, _opt())
    state = TrainState(params, _opt().init(params))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return grads, losses


def _one_rank_infer(arch, over, inputs, bits=16):
    cfg = _cfg(arch, over)
    model = Model(cfg)
    params = params_from_numpy(inputs["weights"][arch], cfg, "cpu")
    if bits < 16:
        params = model.quantize_params(params, bits)
    x = inputs["infer"][arch]
    with _Codes() as codes:
        pre = model.prefill(params, batch_to_device(x["prefill"], "cpu"))
        out = {"prefill": pre, "codes": codes.codes}
        for mode in CUR_MODES:
            steps, caches = _decode(model, params, x, mode)
            out[mode] = {"decode": steps, "caches": caches}
    return out


def _grads_close(got, want, tol):
    for (path, g), w in zip(leaves_with_paths(got), leaves(want)):
        scale = float(w.abs().max())
        err = float((g.detach() - w).abs().max())
        assert err <= tol * max(scale, 1e-30), (path, err, scale)


def _worst_of_max(got, want):
    return max(float((a.detach() - b).abs().max()) / float(b.abs().max())
               for a, b in zip(leaves(got), leaves(want)))


class _OneUlpNoise:
    """Every ``layers`` matmul's output times (1 + one ulp x a seeded
    normal draw): the rounding noise another summation order adds."""

    def __init__(self):
        from repro_torch.models import layers
        self.layers, self.real = layers, torch.matmul
        self.gen = torch.Generator().manual_seed(1)

    def __enter__(self):
        real, gen = self.real, self.gen

        def noisy(a, b):
            y = real(a, b)
            return y * (1 + ULP * torch.randn(y.shape, generator=gen))
        self.layers.torch.matmul = noisy
        return self

    def __exit__(self, *exc):
        self.layers.torch.matmul = self.real


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_mamba_and_hybrid_training_match_reference_and_one_rank(runs, name):
    """3 losses on the case's mesh: the same on every rank, within
    ``LOSS_RTOL`` of the reference's 4-device GSPMD run and of the port
    on one rank; the first step's gradients within ``GRAD_TOL`` of each
    leaf's largest |g| of the one-rank port."""
    ranks, reference, inputs = runs
    arch, over, _, strategy = TRAIN_CASES[name]
    losses = [ranks[r]["train"][name]["losses"] for r in range(WORLD)]
    assert all(ls == losses[0] for ls in losses), losses
    np.testing.assert_allclose(
        losses[0], reference["train"][_ref_key(arch, over, strategy)],
        rtol=LOSS_RTOL)
    grads, one = _one_rank_train(arch, over, inputs)
    np.testing.assert_allclose(losses[0], one, rtol=LOSS_RTOL)
    for r in range(WORLD):
        _grads_close(ranks[r]["train"][name]["grads"], grads, GRAD_TOL[arch])


@pytest.fixture(scope="module")
def one_rank_infer(runs):
    _, _, inputs = runs
    return {key: _one_rank_infer(arch, over, inputs)
            for key, (arch, over) in INFER_MODELS.items()}


def _infer_id(key, strategy, shape, mode):
    mid = "" if strategy == "baseline" else strategy.replace(",", "+") + "-"
    return f"{key}-{mid}{shape[0]}x{shape[1]}-{mode}"


@pytest.mark.parametrize("key,strategy,shape,mode", INFER_CASES,
                         ids=[_infer_id(*c) for c in INFER_CASES])
def test_prefill_and_decode_match_reference_and_one_rank(
        runs, one_rank_infer, key, strategy, shape, mode):
    """The prefill's and every decode step's gathered logits, the same on
    every rank, within ``LOGIT_TOL`` of the one-rank port's and of the
    reference's 4-device run under the same rules; the gathered caches
    after the steps within ``CACHE_TOL`` of the one-rank port's."""
    ranks, reference, _ = runs
    arch, over = INFER_MODELS[key]
    one = one_rank_infer[key]
    ref = reference["infer"][_ref_key(arch, over, strategy)]
    got = ranks[0]["infer"][key, strategy, shape, mode]
    for r in range(1, WORLD):
        other = ranks[r]["infer"][key, strategy, shape, mode]
        assert torch.equal(other["prefill"], got["prefill"])
        assert all(torch.equal(a, b) for a, b in zip(other["decode"],
                                                     got["decode"]))
    for want in (one["prefill"].numpy(), np.asarray(ref["prefill"])):
        np.testing.assert_allclose(got["prefill"].numpy(), want, rtol=0,
                                   atol=LOGIT_TOL)
    for t, logits in enumerate(got["decode"]):
        for want in (one[mode]["decode"][t].numpy(),
                     np.asarray(ref[mode][t])):
            np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                                       atol=LOGIT_TOL, err_msg=f"step {t}")
    for (path, c), w in zip(leaves_with_paths(got["caches"]),
                            leaves(one[mode]["caches"])):
        assert c.shape == w.shape, path
        err, scale = float((c - w).abs().max()), float(w.abs().max())
        assert err <= CACHE_TOL.get(arch, CACHE_TOL_DEFAULT) * scale, (
            path, err, scale)


@pytest.mark.parametrize("shape", INT8_MESHES, ids=[
    f"{s[0]}x{s[1]}" for s in INT8_MESHES])
def test_int8_blocks_codes_and_logits_match_one_rank(runs, shape):
    """The int8 serve path on the mesh: ``quantize_params`` of the rank's
    blocks equal to the blocks of the one-rank tree; every K5 call's
    codes the rank's block of the one-rank call's (its rows of the
    batch; its block of the contraction axis where the linear is
    row-parallel); every row-parallel output one rank's on the gathered
    input, bit for bit; the prefill logits within ``INT8_PREFILL_TOL``
    of the one-rank int8 logits' largest |logit| with top-1 equal at
    every position, the decode steps' within ``INT8_TOL``."""
    ranks, _, inputs = runs
    arch = INT8
    one = _one_rank_infer(arch, {}, inputs, bits=8)
    want_pre = one["prefill"]
    want_steps = one["slots"]["decode"]
    # the one-rank codes of the same calls: the prefill's, then the
    # slot mode's decode steps (run alone, as the ranks ran them)
    cfg = _cfg(arch, {})
    model = Model(cfg)
    params = model.quantize_params(params_from_numpy(
        inputs["weights"][arch], cfg, "cpu"), 8)
    x = inputs["infer"][arch]
    with _Codes() as codes:
        model.prefill(params, batch_to_device(x["prefill"], "cpu"))
        _decode(model, params, x, "slots")
    for r in range(WORLD):
        res = ranks[r]["int8"][shape]
        assert res["blocks_equal"]
        # attention's and the MLP's wo, each of the 2 layers
        assert res["row_parallel_equal"] == [True] * 2 * cfg.n_layers
        scale = float(want_pre.abs().max())
        err = float((res["prefill"] - want_pre).abs().max())
        assert err <= INT8_PREFILL_TOL * scale, (err, scale)
        assert torch.equal(res["prefill"].argmax(-1), want_pre.argmax(-1))
        for got, want in zip(res["decode"], want_steps):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            assert err <= INT8_TOL * scale, (err, scale)
        data, model_rank = res["coords"]
        n_data = shape[0]
        assert len(res["codes"]) == len(codes.codes)
        for mine, whole in zip(res["codes"], codes.codes):
            rows = whole.shape[0] // n_data
            block = whole[data * rows:(data + 1) * rows]
            if mine.shape[1] != block.shape[1]:
                width = mine.shape[1]
                block = block[:, model_rank * width:(model_rank + 1) * width]
            assert torch.equal(mine, block)


def test_int8_decode_drift_is_the_reference_s_own(runs):
    """The int8 decode steps on the mesh leave one rank's as the
    reference's 4-device steps leave its one device: the reference's
    own drift is real (codes flip: some step leaves its one device by
    more than ``INT8_TOL`` of the largest |logit|), and the port's
    flips and drift stay within what the reference shows. A flip is a
    rare event at a rounding boundary on either side, so the port may
    take twice the reference's count of such steps plus two, and twice
    its largest drift. The same on every rank."""
    ranks, reference, _ = runs
    mine, theirs = ranks[0]["int8_drift"], reference["drift"]
    assert len(mine) == len(theirs) == DRIFT_STEPS
    for r in range(1, WORLD):
        assert ranks[r]["int8_drift"] == mine

    def flips(drift):
        return sum(d > INT8_TOL for d in drift)

    assert flips(theirs) >= 1 and max(theirs) > INT8_TOL, theirs
    assert flips(mine) <= 2 * flips(theirs) + 2, (mine, theirs)
    assert max(mine) <= 2 * max(theirs), (max(mine), max(theirs))


def test_jamba_float32_noise_floor(runs):
    """Why jamba's bars are wider than falcon-mamba's: one ulp of noise in
    every linear's output of the one-rank port moves reduced jamba's
    first-step gradients by more than a sixth of its bar, and its caches
    after the slot mode's decode steps by more than a sixth of theirs,
    while falcon-mamba's gradients stay under a sixth of its bar."""
    _, _, inputs = runs
    floors = {}
    for arch, over in (("jamba-v0.1-52b", JAMBA), ("falcon-mamba-7b", {})):
        cfg = _cfg(arch, over)
        model = Model(cfg)
        batch = batch_to_device(inputs["train"][arch][0], "cpu")

        def grads():
            return step_grads(model, params_from_numpy(
                inputs["weights"][arch], cfg, "cpu"), batch)[2]
        clean = grads()
        with _OneUlpNoise():
            noisy = grads()
        floors[arch] = _worst_of_max(noisy, clean)
    assert floors["jamba-v0.1-52b"] > GRAD_TOL["jamba-v0.1-52b"] / 6, floors
    assert floors["falcon-mamba-7b"] < GRAD_TOL["falcon-mamba-7b"] / 6, \
        floors
    cfg = _cfg("jamba-v0.1-52b", JAMBA)
    model = Model(cfg)
    params = params_from_numpy(inputs["weights"]["jamba-v0.1-52b"], cfg,
                               "cpu")
    x = inputs["infer"]["jamba-v0.1-52b"]
    _, clean = _decode(model, params, x, "slots")
    with _OneUlpNoise():
        _, noisy = _decode(model, params, x, "slots")
    floor = _worst_of_max(noisy, clean)
    assert floor > CACHE_TOL["jamba-v0.1-52b"] / 6, floor


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
