"""The port's dry run (``launch/dryrun.py``, ``launch/mesh.py``'s fake
process group) and the meta readiness of the LM's steps.

In a child process (torch's fake process group is process-wide, and
other test modules share this worker): the fake group of 512 ranks, the
production meshes (16, 16) and (2, 16, 16) with the reference's axis
names; ``run_cell`` on a full-width llama3-8b ``train_4k`` cell on both
meshes (its record has the reference's keys; rank 0's own FLOPs, its
state as the arguments and its collectives, each mesh traced on its
own) while the process's resident memory grows by under ``RSS_LIMIT``
(nothing is allocated for the 8B params, their Adam state or the 256 x
4096 batch); ``main`` over a decode cell and a cell skipped by
assignment, and ``--skip-existing``; the strategies' rank-local steps
(``STRATEGY_CELLS``): a ``seqpar`` prefill gathers the sequence and
reduce-scatters where the baseline all-reduces, a ``seqpar`` decode step
is the baseline's, an ``ep`` cell records its collectives, and ``ep`` on
grok-1-314b (8 experts on a 16-wide model axis) errors, naming the
dimension, as the reference's jit refuses the sharding. In a second
child, the
reference's default dry run, ``--all --mesh both``: 64 ok cells, each
with its collective bytes, and 16 skipped.

In this process: the meta branches of K5, K6 and K6's backward (the
kernel's output layout, nothing launched) and no other wrapper's; the
model-built positions reach the flash path with nothing read back from
them, while positions the caller gives are still checked on the CPU; a
reduced prefill and train step counted alike on the CPU and on meta.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import attention as tattn
from repro_torch.models.model import Model
from _torch_threads import one_torch_thread  # noqa: F401

RSS_LIMIT = 1 << 30
#: the keys of the reference's ok record (``repro.launch.dryrun.run_cell``)
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "tag", "quant_bits", "status", "lower_s",
    "compile_s", "n_devices", "batch_axes", "params_local_bytes",
    "state_local_bytes", "cache_local_bytes", "memory_analysis",
    "xla_cost_analysis", "hlo_flops_per_device",
    "collective_bytes_per_device", "collectives_by_type",
    "collectives_count"}
#: the default dry run takes about 270 s on the CPU box in one process;
#: its child traces ``ALL_JOBS`` cells at once (the records are the same:
#: ``test_jobs_trace_the_same_records_as_one_process``)
ALL_TIMEOUT_S = 600
ALL_JOBS = 3
#: (arch, shape, strategy) cells the worker traces beside the defaults,
#: each in a few seconds
STRATEGY_CELLS = (
    ("internlm2-1.8b", "prefill_32k", "baseline"),
    ("internlm2-1.8b", "prefill_32k", "seqpar"),
    ("internlm2-1.8b", "decode_32k", "baseline"),
    ("internlm2-1.8b", "decode_32k", "seqpar"),
    ("llama4-scout-17b-16e", "prefill_32k", "ep"),
    ("grok-1-314b", "decode_32k", "ep"),
)
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _rss() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS")


def _worker(out_dir: str) -> None:
    """The fake-group half, run as this file's ``__main__``: prints one
    JSON object."""
    from repro_torch.launch import mesh as tmesh

    res = {}
    dryrun.ensure_process_group()
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    res["meshes"] = [tmesh.mesh_shape(single), tmesh.mesh_shape(multi),
                     single.size(), multi.size()]
    rss0 = _rss()
    res["cells"] = [dryrun.run_cell("llama3-8b", "train_4k", multi_pod=mp,
                                    out_dir=out_dir, verbose=False)
                    for mp in (False, True)]
    res["rss_growth"] = _rss() - rss0
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--mesh", "both", "--out", out_dir])
    dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                 "--out", out_dir])
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--out", out_dir, "--skip-existing"])
    res["files"] = sorted(os.listdir(out_dir))
    jobs_dir = os.path.join(out_dir, "jobs")
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--mesh", "both", "--out", jobs_dir, "--jobs", "2"])
    res["jobs"] = {}
    for name in sorted(os.listdir(jobs_dir)):
        with open(os.path.join(jobs_dir, name)) as f:
            got = json.load(f)
        with open(os.path.join(out_dir, name)) as f:
            want = json.load(f)
        res["jobs"][name] = [
            key for key in set(got) | set(want)
            if key not in ("lower_s", "compile_s")
            and got.get(key) != want.get(key)]
    res["strategies"] = {
        f"{arch} {shape} {strategy}": dryrun.run_cell(
            arch, shape, strategy=strategy, tag=strategy,
            out_dir=os.path.join(out_dir, "strategies"), verbose=False)
        for arch, shape, strategy in STRATEGY_CELLS}
    print(json.dumps(res))


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The two children, started at once: this file's ``_worker`` and
    the reference's default dry run (``--all --mesh both``). Returns
    ((the worker's JSON, its directory), the dry run's directory)."""
    out = tmp_path_factory.mktemp("dryrun")
    every = tmp_path_factory.mktemp("dryrun_all")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for cmd in ([sys.executable, os.path.abspath(__file__),
                          str(out)],
                         [sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--all", "--mesh", "both", "--jobs", str(ALL_JOBS),
                          "--out", str(every)])]
    outs = [p.communicate(timeout=ALL_TIMEOUT_S) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    return (json.loads(outs[0][0].strip().splitlines()[-1]), out), every


@pytest.fixture(scope="module")
def worker(children):
    return children[0]


def test_production_meshes_over_the_fake_group(worker):
    res, _ = worker
    assert res["meshes"] == [{"data": 16, "model": 16},
                             {"pod": 2, "data": 16, "model": 16}, 256, 512]


def test_full_width_cell_on_meta_allocates_nothing(worker):
    res, _ = worker
    assert res["rss_growth"] < RSS_LIMIT, res["rss_growth"]
    single, multi = res["cells"]
    for rec, n_dev in ((single, 256), (multi, 512)):
        assert rec["status"] == "ok", rec.get("traceback")
        assert REFERENCE_KEYS <= set(rec)
        assert rec["n_devices"] == n_dev
        # rank 0's collectives: FSDP gathers and their reduce-scatters (as
        # all-reduces), Megatron's f / g, the loss's, the gradients'
        assert set(rec["collectives_by_type"]) == {"all-gather",
                                                   "all-reduce"}
        assert rec["collective_bytes_per_device"] == sum(
            rec["collectives_by_type"].values()) > 0
        assert all(n > 0 for n in rec["collectives_count"].values())
        # rank 0's own FLOPs; the cost analysis holds every rank's
        flops = rec["xla_cost_analysis"]["flops"]
        assert flops == rec["hlo_flops_per_device"] * n_dev
        mem = rec["memory_analysis"]
        # the rank's state is its argument: its blocks of the params and
        # of Adam's m and v (and the step count), beside the global batch
        assert rec["state_local_bytes"] > rec["params_local_bytes"] > 0
        assert rec["state_local_bytes"] <= mem["argument_size_in_bytes"] \
            <= rec["state_local_bytes"] + 256 * 4096 * 4 * 2 + 64
        assert mem["temp_size_in_bytes"] > 0
    # each mesh traces its own step: the multi-pod mesh splits the batch
    # over pod x data, so rank 0 does half the single-pod rank's dots
    assert multi["hlo_flops_per_device"] == pytest.approx(
        single["hlo_flops_per_device"] / 2, rel=0.02)
    assert single["batch_axes"] == ["data"]
    assert multi["batch_axes"] == ["pod", "data"]
    # the baseline's FSDP axis is "data" alone (the reference's rule), so
    # the pod axis does not shard the params further
    assert multi["params_local_bytes"] == single["params_local_bytes"]


def _strategy(res, arch, shape, strategy):
    rec = res["strategies"][f"{arch} {shape} {strategy}"]
    assert "not_ported" not in rec
    return rec


def test_seqpar_and_ep_cells_record_their_collectives(worker):
    """Every strategy traces rank 0's own step: a ``seqpar`` prefill
    gathers the residual stream's sequence blocks where the baseline's
    layers take theirs whole and reduce-scatters their outputs where the
    baseline all-reduces them (one of each a sublayer, and the
    embedding's sum), on the same FLOPs; an ``ep`` prefill records its
    collectives (the experts' sum over the model group among them)."""
    res, _ = worker
    base = _strategy(res, "internlm2-1.8b", "prefill_32k", "baseline")
    seq = _strategy(res, "internlm2-1.8b", "prefill_32k", "seqpar")
    for rec in (base, seq):
        assert rec["status"] == "ok", rec.get("traceback")
        assert REFERENCE_KEYS <= set(rec)
        assert rec["collective_bytes_per_device"] == sum(
            rec["collectives_by_type"].values()) > 0
    n = base["collectives_count"]["all-reduce"]
    assert "reduce-scatter" not in base["collectives_count"]
    assert seq["collectives_count"] == {
        "all-gather": base["collectives_count"]["all-gather"] + n,
        "reduce-scatter": n}
    assert seq["hlo_flops_per_device"] == pytest.approx(
        base["hlo_flops_per_device"], rel=1e-3)
    ep = _strategy(res, "llama4-scout-17b-16e", "prefill_32k", "ep")
    assert ep["status"] == "ok", ep.get("traceback")
    assert ep["collective_bytes_per_device"] == sum(
        ep["collectives_by_type"].values()) > 0
    assert ep["collectives_count"]["all-reduce"] > 0


def test_a_seqpar_decode_cell_is_the_baselines(worker):
    """A one-token decode step reads no "seq" rule (the reference's
    ``block_decode`` never shards the sequence): its FLOPs and collectives
    are the baseline's."""
    res, _ = worker
    base = _strategy(res, "internlm2-1.8b", "decode_32k", "baseline")
    seq = _strategy(res, "internlm2-1.8b", "decode_32k", "seqpar")
    assert base["status"] == seq["status"] == "ok"
    for key in ("hlo_flops_per_device", "collective_bytes_per_device",
                "collectives_by_type", "collectives_count"):
        assert seq[key] == base[key], key


def test_ep_refuses_an_expert_count_the_model_axis_does_not_split(worker):
    """grok-1-314b's 8 experts on the 16-wide model axis: the cell is an
    error, as the reference's (its jit refuses the in_sharding), and the
    error names the experts' dimension."""
    res, _ = worker
    rec = _strategy(res, "grok-1-314b", "decode_32k", "ep")
    assert rec["status"] == "error"
    assert rec["error"].startswith("ValueError: dimension 1 of (64, 8, ")
    assert "does not split into 16 blocks" in rec["error"]


def test_every_default_cell_records_its_collectives(children):
    """``--all --mesh both``: 64 ok cells and 16 skipped by assignment;
    every ok cell has its rank-local step's collective bytes (no null),
    and a rank's FLOPs, not an even split of the global count."""
    _, every = children
    recs = []
    for name in sorted(os.listdir(every)):
        with open(every / name) as f:
            recs.append(json.load(f))
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == 64 and len(recs) == 80, [
        (r["arch"], r["shape"], r["status"]) for r in recs
        if r["status"] not in ("ok", "skipped")]
    missing = [(r["arch"], r["shape"], r["mesh"]) for r in ok
               if r["collective_bytes_per_device"] is None
               or not r["collective_bytes_per_device"] > 0]
    assert not missing, missing
    for r in ok:
        assert r["collective_bytes_per_device"] == sum(
            r["collectives_by_type"].values())
        assert r["xla_cost_analysis"]["flops"] == \
            r["hlo_flops_per_device"] * r["n_devices"]


def test_main_writes_ok_and_skipped_records(worker):
    res, out = worker
    assert res["files"] == [
        "hubert-xlarge__decode_32k__single__baseline.json",
        "internlm2-1.8b__decode_32k__multi__baseline.json",
        "internlm2-1.8b__decode_32k__single__baseline.json",
        "llama3-8b__train_4k__multi__baseline.json",
        "llama3-8b__train_4k__single__baseline.json"]
    with open(out / res["files"][0]) as f:
        rec = json.load(f)
    assert rec["status"] == "skipped" and "encoder-only" in rec["reason"]
    with open(out / res["files"][1]) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["cache_local_bytes"] > 0


def test_jobs_trace_the_same_records_as_one_process(worker):
    """``--jobs 2`` traces each cell in a child process of its own: the
    records equal the one-process run's but for the seconds."""
    res, _ = worker
    assert res["jobs"] == {
        "internlm2-1.8b__decode_32k__multi__baseline.json": [],
        "internlm2-1.8b__decode_32k__single__baseline.json": []}


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def test_k5_meta_branch_returns_the_kernel_output():
    x = torch.empty(5, 64, dtype=torch.int8, device="meta")
    w = torch.empty(64, 7, dtype=torch.int8, device="meta")
    sc = torch.empty(7, device="meta")
    ops.reset_launches()
    out = ops.qmatmul(x, w, sc)
    assert (out.device.type, out.shape, out.dtype) == ("meta", (5, 7),
                                                       torch.float32)
    out = ops.qmatmul(x, w, sc, out_scale=0.5)
    assert out.dtype == torch.int8
    assert sum(ops.launches.values()) == 0
    with pytest.raises(ValueError):      # the checks still run
        ops.qmatmul(x, w[:32], sc)


def test_k6_meta_branches_keep_the_kernel_layouts():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 40, h, 16, generator=g).transpose(1, 2)
               for h in (4, 2, 2))
    mq, mk, mv = (t.to("meta") for t in (q, k, v))
    cpu = ops.flash_attention(q, k, v, causal=True)
    meta = ops.flash_attention(mq, mk, mv, causal=True)
    # the kernel writes its output in q's layout (the CUDA path's
    # ``empty_like(q)``; the CPU's plain version returns a fresh tensor)
    assert meta.shape == cpu.shape and meta.stride() == mq.stride() == \
        q.stride()
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (mq, mk, mv))
    out = ops.flash_attention(qg, kg, vg, causal=True)
    grads = torch.autograd.grad(out.sum(), (qg, kg, vg))
    for gr, t in zip(grads, (mq, mk, mv)):
        assert gr.shape == t.shape and gr.stride() == t.stride()
    lse = torch.empty(2, 4, 40, device="meta")
    dq, dk, dv = ops.flash_attention_bwd(mq, mk, mv, meta, lse, meta)
    assert dk.shape == mk.shape and dq.device.type == "meta"
    with pytest.raises(ValueError, match="head dim"):    # the kernel's limit
        ops.flash_attention(torch.empty(1, 2, 8, 24, device="meta"),
                            *(torch.empty(1, 2, 8, 24, device="meta"),) * 2)


def test_other_wrappers_raise_on_meta():
    m = dict(device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.threshold_matmul(torch.empty(4, 8, dtype=torch.int32, **m),
                             torch.empty(8, 3, dtype=torch.int8, **m),
                             torch.empty(3, 2, dtype=torch.int32, **m))
    with pytest.raises(ValueError, match="meta"):
        ops.multi_threshold(torch.empty(4, 3, dtype=torch.int32, **m),
                            torch.empty(3, 2, dtype=torch.int32, **m))
    with pytest.raises(ValueError, match="meta"):
        ops.float_head(torch.empty(4, 8, dtype=torch.int32, **m),
                       torch.empty(8, 3, **m), 1.0, torch.empty(3, **m))
    with pytest.raises(ValueError, match="meta"):
        ops.conv_threshold(torch.empty(1, 4, 4, 2, dtype=torch.int32, **m),
                           torch.empty(18, 3, dtype=torch.int8, **m),
                           torch.empty(3, 2, dtype=torch.int32, **m),
                           kernel=3, stride=1, padding="SAME", out_h=4,
                           out_w=4)
    with pytest.raises(ValueError, match="meta"):
        ops.mlp_megakernel(torch.empty(4, 8, dtype=torch.int32, **m),
                           [torch.empty(8, 3, dtype=torch.int8, **m)],
                           [torch.empty(2, 3, dtype=torch.int32, **m)])


# ---------------------------------------------------------------------------
# positions: the model's own are not read back; a caller's are checked
# ---------------------------------------------------------------------------

def _chunked(arch="llama3-8b"):
    return dataclasses.replace(get_config(arch).reduced(),
                               attn_impl="chunked")


def test_caller_positions_that_are_not_an_arange_still_raise():
    cfg = _chunked()
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    with pytest.raises(ValueError, match="arange"):
        m.prefill(p, {"tokens": tokens, "positions": pos.flip(-1)})
    with pytest.raises(ValueError, match="start at 0"):
        m.prefill(p, {"tokens": tokens, "positions": pos + 3})
    # the caller's arange is checked and accepted, and gives the logits
    # of the model's own positions
    torch.testing.assert_close(m.prefill(p, {"tokens": tokens,
                                             "positions": pos}),
                               m.prefill(p, {"tokens": tokens}),
                               rtol=0, atol=0)


def test_model_built_positions_make_no_host_read(monkeypatch):
    """The model's own positions never reach ``_arange_offset`` (no
    ``int(pos[0])``, no ``torch.equal``: a host sync each on the card),
    and the prefill traces on meta, where any read of a value raises."""
    cfg = _chunked()
    m = Model(cfg)
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    want = m.prefill(p, {"tokens": tokens})

    def refuse(pos, name):
        raise AssertionError(f"{name} read back")

    monkeypatch.setattr(tattn, "_arange_offset", refuse)
    torch.testing.assert_close(m.prefill(p, {"tokens": tokens}), want,
                               rtol=0, atol=0)
    mp = m.init(None, device="meta")
    out = m.prefill(mp, {"tokens": tokens.to("meta")})
    assert out.device.type == "meta" and out.shape == (2, 16, cfg.vocab)


@pytest.mark.parametrize("arch", ["llama3-8b", "jamba-v0.1-52b",
                                  "qwen2-vl-2b"])
@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
def test_reduced_steps_count_alike_on_cpu_and_meta(arch, kind):
    """The same step traced on the CPU (seeded weights) and on meta:
    equal FLOPs, argument bytes and kernel calls."""
    cfg = _chunked(arch)
    shape = ShapeConfig(kind, 32, 2, kind)
    model = Model(cfg)
    _, meta = dryrun._abstract_trees(cfg, shape, 16)
    # two microbatches split every batch array on its first axis, which
    # M-RoPE's (3, B, S) positions do not have batch-first
    mb = 2 if kind == "train" and not cfg.mrope else 1
    got_meta = dryrun.trace_step(model, shape, meta, mb)
    g = torch.Generator().manual_seed(3)
    cpu = {"params": model.init(g, device="cpu"),
           "batch": {k: (torch.randint(0, cfg.vocab, tuple(v.shape),
                                       generator=g, dtype=v.dtype)
                         if v.dtype == torch.int32 else
                         torch.randn(tuple(v.shape), generator=g).to(v.dtype))
                     for k, v in meta["batch"].items()}}
    if "positions" in cpu["batch"]:
        cpu["batch"]["positions"] = torch.arange(32, dtype=torch.int32)[
            None, None].expand(3, 2, 32).contiguous()
    if kind == "train":
        from repro_torch.optim.adamw import make_optimizer
        cpu["opt"] = make_optimizer().init(cpu["params"])
    if kind == "decode":
        cpu["cache"] = model.cache_init(2, 32, device="cpu")
    got_cpu = dryrun.trace_step(model, shape, cpu, mb)
    assert got_cpu.stats.flops == got_meta.stats.flops > 0
    assert got_cpu.argument_bytes == got_meta.argument_bytes
    assert [k[:3] for k in got_cpu.kernels] == \
        [k[:3] for k in got_meta.kernels]


if __name__ == "__main__":
    _worker(sys.argv[1])
