"""The port's mesh layer on the CPU against the JAX package:
``parallel/sharding.py``, ``launch/mesh.py``, ``parallel/collectives.py``,
the MoE's mesh branch and the compressed DDP step.

One rank (a ``gloo`` group of one, in this process, up for the module's
tests that ask for it) against the reference on its one-device mesh:

  * ``logical_to_spec`` / ``batch_axes`` / ``model_axes`` /
    ``mesh_axis_size`` for every logical axis, under the default rules
    and overridden ones, on ("data", "model") and ("pod", "data",
    "model") meshes and without a mesh: equal entry for entry;
  * ``make_elastic_mesh``'s shape: the reference's clamp for 1-8 ranks
    and model parallelism 1-4;
  * ``compressed_psum`` / ``compressed_psum_tree`` bit for bit;
  * ``moe_apply`` under the mesh equal bit for bit to itself without one,
    and within ``TOL`` of the reference's ``shard_map`` branch;
  * the DDP step's losses against the reference's (``LOSS_RTOL``).

Two ranks (``gloo``, two processes started once for the module, each
this file run as a script): ``compressed_psum`` bit for bit against a
numpy copy of the reference's formula; the MoE's mesh branch on
("data", "model") meshes (2, 1) and (1, 2), with and without remat,
against one process on the global batch: output, aux loss and the
gradients of x, the router and the expert blocks under the convention
``moe_apply`` states; the DDP step keeps the params equal on both ranks
and its loss falls.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.models import layers as jlayers
from repro.models.layers import shard_map
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.parallel import collectives as jcoll
from repro.parallel import sharding as jsharding
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.model import params_from_numpy
from repro_torch.optim.adamw import make_optimizer
from repro_torch.parallel import collectives as tcoll
from repro_torch.parallel import sharding as tsharding
from repro_torch.train import steps as tsteps
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)     # float32 MoE against the reference
#: two ranks' partial sums over d_ff against one sum: float32 rounding
SPLIT_TOL = dict(rtol=1e-5, atol=1e-6)
#: the DDP toy's losses, float32: the reference's step is jitted (60
#: eager steps take minutes), and XLA divides by the int8 scale as a
#: multiply by its reciprocal, an ulp off; the trajectories agree within
#: 1e-5 relative, and within 1e-6 of the first loss as they near 0
LOSS_RTOL = 1e-5
LOSS_ATOL_OF_FIRST = 1e-6
MOE = "jamba-v0.1-52b"
OVERRIDE = {"batch": ("data",), "experts": ("model",), "mlp": None,
            "seq": ("model",), "embed": ("pod", "model")}
WORKER_TIMEOUT_S = 120


def _jmesh(names):
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(names)),
                names)


@pytest.fixture(scope="module")
def one_rank():
    """A gloo group of one rank in this process, for the module."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_launcher_trains_on_its_own_one_rank_mesh(tmp_path, caplog):
    """``--model-parallel 2`` as a plain process: the launcher brings up
    a group of one rank, trains on a (1, 1) mesh and takes the group
    down."""
    from repro_torch.launch import train as launch_train

    assert not dist.is_initialized()
    with caplog.at_level("INFO", logger="repro_torch.launch.train"):
        res = launch_train.main(["--arch", "llama3-8b", "--reduced",
                                 "--model-parallel", "2", "--steps", "10",
                                 "--batch", "2", "--seq", "16", "--device",
                                 "cpu", "--ckpt-dir", str(tmp_path)])
    assert res.final_step == 10
    assert np.isfinite(res.metrics_history[-1]["loss"])
    assert "mesh {'data': 1, 'model': 1} over 1 ranks" in caplog.text
    assert not dist.is_initialized()


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model"), None])
@pytest.mark.parametrize("rules", [None, OVERRIDE])
def test_logical_rules_match_reference(one_rank, names, rules):
    tm = (None if names is None else
          tmesh._mesh([0], (1,) * len(names), names))
    jm = None if names is None else _jmesh(names)
    specs = [(a,) for a in tsharding.LOGICAL_RULES] + [
        ("batch", None, "vocab"), ("fsdp", "mlp"), (None, None),
        ("experts", "fsdp", "mlp"), ("nope",)]
    with jsharding.use_mesh_rules(jm, rules), \
            tsharding.use_mesh_rules(tm, rules):
        for axes in specs:
            assert tsharding.logical_to_spec(axes) == \
                tuple(jsharding.logical_to_spec(axes)), axes
        assert tsharding.batch_axes() == jsharding.batch_axes()
        assert tsharding.model_axes() == jsharding.model_axes()
        for a in ("pod", "data", "model", "nope"):
            assert tsharding.mesh_axis_size(a) == jsharding.mesh_axis_size(a)
        assert tsharding.active_rules() == jsharding.active_rules()
        assert tsharding.active_mesh() is tm
    assert tsharding.active_mesh() is None
    assert tsharding.active_rules() == tsharding.LOGICAL_RULES


def test_mesh_rules_are_per_thread_and_shard_checks_axes(one_rank):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = tmesh.make_elastic_mesh(2)
    seen = {}
    x = torch.arange(6.0).reshape(2, 3)
    with tsharding.use_mesh_rules(mesh):
        t = threading.Thread(target=lambda: seen.update(
            mesh=tsharding.active_mesh(), rules=tsharding.active_rules()))
        t.start()
        t.join(10)
        assert not t.is_alive()
        assert tsharding.shard(x, ("batch", "vocab")) is x
        with pytest.raises(ValueError):
            tsharding.shard(x, ("batch",))
        with pytest.raises(KeyError):
            tsharding.shard(x, ("batch", "nope"))
        m, placements = tsharding.named_sharding(("batch", "vocab"))
        assert m is mesh and placements == [Shard(0), Shard(1)]
        assert tsharding.named_sharding(("vocab", None))[1] == \
            [Replicate(), Shard(0)]
        dt = distribute_tensor(x, m, placements)
        assert torch.equal(dt.full_tensor(), x)
    assert seen == {"mesh": None, "rules": tsharding.LOGICAL_RULES}
    assert tsharding.shard(x, ("batch",)) is x       # no mesh: identity
    assert tsharding.named_sharding(("batch",)) is None


def test_elastic_mesh_matches_reference_clamp(one_rank):
    dev = jax.devices()[0]
    for n in range(1, 9):
        for mp in range(1, 5):
            want = jmesh.make_elastic_mesh(mp, [dev] * n)
            assert tmesh.elastic_shape(mp, n) == (want.shape["data"],
                                                  want.shape["model"])
    mesh = tmesh.make_elastic_mesh(2)
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and tmesh.mesh_devices(mesh) == 1
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError):
            tmesh.make_production_mesh(multi_pod=multi_pod)


def _jpsum(fn, *args):
    """``fn`` under the reference's ``shard_map`` on a one-device mesh,
    eager: jitted, XLA turns its divisions by the scale into multiplies by
    the reciprocal, which the port (and the eager reference) do not."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("data",))
    return shard_map(fn, mesh, in_specs=tuple(P() for _ in args),
                     out_specs=(P(), P()))(*args)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_matches_reference(one_rank, dtype):
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(256) * 0.01).astype(np.float32)
    jg = jnp.asarray(g, jnp.bfloat16 if dtype == "bfloat16" else
                     jnp.float32)
    want_mean, want_err = _jpsum(
        lambda x: jcoll.compressed_psum(x, ("data",), 1), jg)
    tg = torch.from_numpy(np.asarray(jg, np.float32)).to(
        getattr(torch, dtype))
    mean, err = tcoll.compressed_psum(tg, None, 1)
    assert mean.dtype == tg.dtype and err.dtype == torch.float32
    np.testing.assert_array_equal(mean.float().numpy(),
                                  np.asarray(want_mean, np.float32))
    np.testing.assert_array_equal(err.numpy(), np.asarray(want_err))


def test_compressed_psum_tree_matches_reference(one_rank):
    """Two steps, the first without error feedback (None), the second
    with the first's, bit for bit; and the bytes-saved count."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal(5), "b": {"c": rng.standard_normal(
        (2, 3)) * 1e-3}}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    jerr = terr = None
    for step in range(2):
        jg = jax.tree.map(lambda a: jnp.asarray(a * (step + 1)), tree)
        tg = jax.tree.map(lambda a: torch.from_numpy(a * (step + 1)), tree)
        if jerr is None:
            jmean, jerr = _jpsum(lambda t: jcoll.compressed_psum_tree(
                t, None, ("data",), 1), jg)
        else:
            jmean, jerr = _jpsum(lambda t, e: jcoll.compressed_psum_tree(
                t, e, ("data",), 1), jg, jerr)
        tmean, terr = tcoll.compressed_psum_tree(tg, terr, None, 1)
        for got, want in ((tmean, jmean), (terr, jerr)):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tcoll.collective_bytes_saved(tg) == jcoll.collective_bytes_saved(
        jg) == 11 * 3


def _moe_pair():
    jcfg = jget_config(MOE).reduced()
    cfg = get_config(MOE).reduced()
    jp = jax.jit(jlayers.moe_init, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    p = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       jp), cfg, "cpu")
    x = np.random.default_rng(2).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)
    return jcfg, jp, cfg, p, x


def test_moe_mesh_branch_on_one_rank(one_rank):
    """On a (1, 1) mesh the gathers and the sum are over one rank: equal
    bit for bit to the branch without a mesh, gradients too; within TOL
    of the reference's ``shard_map`` branch on its one-device mesh."""
    jcfg, jp, cfg, p, x = _moe_pair()
    tx = torch.from_numpy(x)
    runs = []
    for mesh in (None, tmesh.make_elastic_mesh(2)):
        q = {k: (v.clone().requires_grad_(True) if k != "router" else v)
             for k, v in p.items()}
        with tsharding.use_mesh_rules(mesh):
            y, aux = tlayers.moe_apply(cfg, q, tx)
        grads = torch.autograd.grad((y * y).sum() + aux,
                                    [q["wi_gate"], q["wo"]])
        runs.append((y.detach(), aux.detach(), grads))
    (y0, a0, g0), (y1, a1, g1) = runs
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    with jsharding.use_mesh_rules(_jmesh(("data", "model"))):
        jy, jaux = jax.jit(functools.partial(jlayers.moe_apply, jcfg))(
            jp, jnp.asarray(x))
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(a1), float(jaux), rtol=1e-6)


def test_ddp_compressed_step_matches_reference(one_rank):
    """The reference's ``test_ddp_compressed_step_trains`` toy (least
    squares on 3 weights, 60 steps; the reference's step jitted) on
    one-rank meshes: the losses agree (``LOSS_RTOL``,
    ``LOSS_ATOL_OF_FIRST``), and the last is under 0.05 of the first, the
    reference's bar."""
    w_true = np.asarray([2.0, -1.0, 0.5], np.float32)

    def jloss(params, batch):
        return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2), {}

    def tloss(params, batch):
        return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean(), {}

    jopt = jmake_optimizer(base_lr=0.05, warmup=1, total=100,
                           weight_decay=0.0)
    topt = make_optimizer(base_lr=0.05, warmup=1, total=100,
                          weight_decay=0.0)
    jstate = jsteps.init_ddp_state({"w": jnp.zeros(3)}, jopt)
    tstate = tsteps.init_ddp_state({"w": torch.zeros(3)}, topt)
    jstep = jax.jit(jsteps.make_ddp_compressed_step(
        jloss, jopt, Mesh(np.array(jax.devices()[:1]).reshape(1),
                          ("data",))))
    tstep = tsteps.make_ddp_compressed_step(tloss, topt,
                                            tmesh.make_elastic_mesh(1))
    rng = np.random.default_rng(0)
    jl, tl = [], []
    for _ in range(60):
        x = rng.standard_normal((16, 3)).astype(np.float32)
        batch = {"x": x, "y": x @ w_true}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tm = tstep(tstate, batch)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL_OF_FIRST * jl[0])
    assert tl[-1] < 0.05 * tl[0]


# ---------------------------------------------------------------------------
# two ranks
# ---------------------------------------------------------------------------

def _rank_inputs(rank):
    rng = np.random.default_rng(10 + rank)
    return (rng.standard_normal(64) * (0.01 if rank else 0.03)).astype(
        np.float32)


def _block(t, dim, n, i):
    return t.chunk(n, dim=dim)[i].contiguous()


def _in_thread(fn):
    """``fn()`` on a thread of its own, as autograd runs a backward (and a
    remat block's recompute) on its device thread on the card: the
    caller's thread-local mesh is not active there."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:                     # noqa: BLE001
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(WORKER_TIMEOUT_S)
    if "error" in out:
        raise out["error"]
    return out["value"]


def _moe_loss(y, aux):
    """A rank's loss: the mean over its tokens, plus the aux loss."""
    return (y * y).mean() + aux


MOE_GRAD_KEYS = ("router", "wi_gate", "wi_up", "wo")


def _moe_grads(cfg, q, x, mesh, remat):
    """(y, aux, grads of ``_moe_loss`` for x and ``MOE_GRAD_KEYS``, the
    router's gradient of aux alone), forward under ``mesh`` (remat: the
    block under ``cfg.remat = "full"``), the backward on another thread."""
    fn = functools.partial(tlayers.moe_apply, cfg)
    if remat:
        fn = ttransformer._remat(dataclasses.replace(cfg, remat="full"), fn)
    x = x.clone().requires_grad_(True)
    q = {k: v.clone().requires_grad_(True) for k, v in q.items()
         if k != "router"} | {
        "router": {"w": q["router"]["w"].clone().requires_grad_(True)}}
    wrt = [x, q["router"]["w"]] + [q[k] for k in MOE_GRAD_KEYS[1:]]
    with tsharding.use_mesh_rules(mesh):
        y, aux = fn(q, x)
        grads = _in_thread(lambda: torch.autograd.grad(_moe_loss(y, aux),
                                                       wrt))
        g_aux = None
        if not remat:
            _, aux = fn(q, x)
            g_aux = _in_thread(lambda: torch.autograd.grad(
                aux, [q["router"]["w"]])[0])
    return y.detach(), aux.detach(), list(grads), g_aux


def _worker(rank, world, init, out):
    """One of two ranks: every two-rank case, results into ``out``."""
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    res = {}
    g = torch.from_numpy(_rank_inputs(rank))
    res["psum"] = tcoll.compressed_psum(g, None, world)
    res["psum_bf16"] = tcoll.compressed_psum(g.to(torch.bfloat16), None,
                                             world)
    _, _, cfg, p, x = _moe_pair()
    for shape in ((2, 1), (1, 2)):
        mesh = tmesh.make_elastic_mesh(shape[1])
        assert tuple(mesh.shape) == shape
        dr, mr = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        q = {"router": p["router"],
             "wi_gate": _block(_block(p["wi_gate"], 1, shape[0], dr), 2,
                               shape[1], mr),
             "wi_up": _block(_block(p["wi_up"], 1, shape[0], dr), 2,
                             shape[1], mr),
             "wo": _block(_block(p["wo"], 2, shape[0], dr), 1, shape[1], mr)}
        xl = _block(torch.from_numpy(x), 0, shape[0], dr)
        for remat in (False, True):
            res[shape, remat] = _moe_grads(cfg, q, xl, mesh, remat)
    mesh = tmesh.make_elastic_mesh(1)
    opt = make_optimizer(base_lr=0.05, warmup=1, total=100, weight_decay=0.0)
    state = tsteps.init_ddp_state({"w": torch.zeros(3)}, opt)
    step = tsteps.make_ddp_compressed_step(
        lambda pr, b: (((b["x"] @ pr["w"] - b["y"]) ** 2).mean(), {}), opt,
        mesh)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(60):
        xb = rng.standard_normal((16, 3)).astype(np.float32)
        state, m = step(state, {"x": xb, "y": xb @ np.asarray(
            [2.0, -1.0, 0.5], np.float32)})
        losses.append(float(m["loss"]))
    res["ddp"] = (losses, state.params["w"].detach())
    torch.save(res, out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results: this file run twice as a script, once."""
    d = tmp_path_factory.mktemp("two_ranks")
    init = f"file://{d / 'store'}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "2", init, str(d / f"{r}.pt")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0].decode()
            for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    return [torch.load(d / f"{r}.pt", weights_only=False) for r in range(2)]


def test_two_rank_compressed_psum_equals_reference_formula(two_ranks):
    """The reference's order in numpy float32: the shared scale from the
    max |g|, codes clipped to +-127, their exact sum, mean = total *
    (scale / 2), the residual g - q * scale."""
    gs = [_rank_inputs(r) for r in range(2)]
    f32 = np.float32
    scale = np.maximum(max(np.abs(g).max() for g in gs), f32(1e-12)) / f32(
        127.0)
    qs = [np.clip(np.round(g / scale), -127, 127).astype(np.int32)
          for g in gs]
    mean = (qs[0] + qs[1]).astype(f32) * (scale / f32(2))
    for r in range(2):
        got_mean, got_err = two_ranks[r]["psum"]
        np.testing.assert_array_equal(got_mean.numpy(), mean)
        np.testing.assert_array_equal(got_err.numpy(),
                                      gs[r] - qs[r].astype(f32) * scale)
    m0, m1 = (two_ranks[r]["psum_bf16"][0] for r in range(2))
    assert m0.dtype == torch.bfloat16 and torch.equal(m0, m1)


def _global_grads(cfg, p, x, ranks):
    """One process, the global batch split into ``ranks`` token blocks
    (each with its own capacity, as each data rank dispatches its own):
    the global loss, the mean of the blocks' ``_moe_loss`` with the aux
    loss of all tokens, and its gradients for x and ``MOE_GRAD_KEYS``;
    also the router's gradient of aux alone. Returns (ys, aux, grads,
    g_aux)."""
    x = torch.from_numpy(x).requires_grad_(True)
    q = {k: v.clone().requires_grad_(True) for k, v in p.items()
         if k != "router"} | {
        "router": {"w": p["router"]["w"].clone().requires_grad_(True)}}
    wrt = [x, q["router"]["w"]] + [q[k] for k in MOE_GRAD_KEYS[1:]]
    _, aux = tlayers.moe_apply(cfg, q, x)
    ys = [tlayers.moe_apply(cfg, q, xb)[0] for xb in x.chunk(ranks)]
    loss = sum(_moe_loss(y, aux) for y in ys) / ranks
    grads = torch.autograd.grad(loss, wrt, retain_graph=True)
    g_aux = torch.autograd.grad(aux, [q["router"]["w"]])[0]
    return [y.detach() for y in ys], aux.detach(), grads, g_aux


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SPLIT_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_two_rank_moe_mesh_branch_equals_local(two_ranks, remat):
    """Against one process on the global batch, the mesh branch's output,
    aux loss (all 4 x 8 tokens) and the gradients of x, the router and
    the expert blocks, with the block under remat too (its recompute on
    the backward's thread).

    (2, 1): each rank's tokens through the whole experts (gathered from
    the two d blocks), its own capacity. Each rank's backward gives the
    sum of the two ranks' losses' gradient of what it holds: twice the
    global loss's for its tokens and its expert blocks; for the
    replicated router the two ranks' mean is the global loss's gradient,
    the aux loss's part alone too. (1, 2): the d_ff halves' partial
    outputs summed; both ranks hold the global loss's gradient of x and
    the router, and each its half of the expert tensors'."""
    _, _, cfg, p, x = _moe_pair()
    ys, aux_all, gx, g_aux = _global_grads(cfg, p, x, 2)
    router = []
    for r in range(2):
        y, aux, grads, ga = two_ranks[r][(2, 1), remat]
        assert torch.equal(y, ys[r])
        np.testing.assert_allclose(float(aux), float(aux_all), rtol=1e-6)
        _close(grads[0], 2 * _block(gx[0], 0, 2, r))
        for got, want, dim in zip(grads[2:], gx[2:], (1, 1, 2)):
            _close(got, 2 * _block(want, dim, 2, r))
        router.append((grads[1], ga))
    _close((router[0][0] + router[1][0]) / 2, gx[1])
    if not remat:
        _close((router[0][1] + router[1][1]) / 2, g_aux)
    (y_all,), aux_all, gx, g_aux = _global_grads(cfg, p, x, 1)
    for r in range(2):
        y, aux, grads, ga = two_ranks[r][(1, 2), remat]
        _close(y, y_all)
        assert torch.equal(aux, aux_all)
        _close(grads[0], gx[0])
        _close(grads[1], gx[1])
        if not remat:
            _close(ga, g_aux)
        for got, want, dim in zip(grads[2:], gx[2:], (2, 2, 1)):
            _close(got, _block(want, dim, 2, r))


def test_two_rank_ddp_step_keeps_params_replicated(two_ranks):
    (l0, w0), (l1, w1) = (two_ranks[r]["ddp"] for r in range(2))
    assert l0 == l1 and torch.equal(w0, w1)
    assert l0[-1] < 0.05 * l0[0]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
