"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the meta
device.

The port of ``repro.launch.dryrun``: the same functions, flags and record
keys. What does not carry over is XLA: the reference lowers and compiles
each cell's jitted step for 512 fake host devices and reads the
partitioned HLO. The port has no XLA, no HLO and no SPMD partitioner (its
model partitions itself, one process a rank: the rank-local step is not
traced here), so for each cell this module:

  1. builds the production mesh (16 x 16 single-pod / 2 x 16 x 16
     multi-pod) over torch's ``fake`` process group: 512 ranks in this
     one process, nothing moved (``launch.mesh.init_fake_process_group``;
     ``main`` and ``run_cell`` bring it up when no group is);
  2. builds the params, the optimizer state, the caches and the batch on
     the ``meta`` device: shapes and dtypes, nothing allocated (the
     reference's ``jax.eval_shape``);
  3. runs the cell's global step once on them, under the op-trace
     analysis (``launch.hlo_analysis``): ``train.steps.make_train_step``
     with ``optim.adamw``, ``Model.prefill``, or ``Model.decode_step`` on
     ``Model.cache_init``. The kernels take their meta branches (K5, K6
     and K6's backward: counted by their own formulas, nothing launched);
  4. records what the reference records, from the spec trees under the
     mesh's rules and from the trace:

     * ``params_local_bytes``, ``state_local_bytes``,
       ``cache_local_bytes``: ``local_bytes`` of the spec trees
       (``Model.param_specs`` / ``cache_specs``), the reference's
       arithmetic;
     * ``hlo_flops_per_device``: the traced FLOPs divided evenly over the
       mesh's devices. The reference's partitioned count also holds the
       work every device repeats (replicated norms, the router, ...), so
       it reads higher where such work is large;
     * ``memory_analysis``: the trace's argument bytes, output bytes, and
       the peak live bytes above the arguments (``temp_size_in_bytes``),
       for the global step on one device;
     * ``xla_cost_analysis``: the traced FLOPs and bytes accessed (every
       op's operand and result bytes, a kernel's once), global;
     * ``collective_bytes_per_device``: null, ``collectives_by_type`` and
       ``collectives_count`` empty: no partitioner places collectives;
     * ``lower_s``: seconds to build the meta trees; ``compile_s``: the
       traced step's seconds.

The trace does not depend on the mesh, so it is run once per (arch,
shape, options) and both meshes read it. A failing cell is recorded with
``status: "error"`` and its traceback; ``--all`` exits 1 if any failed.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both   # every cell
  ... --mesh multi --seq-parallel --quant 8 --remat dots  # variants
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.launch.hlo_analysis import analyze_call
from repro_torch.launch.mesh import (init_fake_process_group,
                                     make_production_mesh, mesh_shape)
from repro_torch.models.layers import _dtype
from repro_torch.models.model import Model
from repro_torch.obs import timer as obs_timer
from repro_torch.optim.adamw import make_optimizer
from repro_torch.parallel.sharding import use_mesh_rules
from repro_torch.train.steps import TrainState, make_train_step

#: ranks of the fake process group: the multi-pod mesh's
FAKE_WORLD = 512


def _entry(axes):
    """A spec entry as the reference's ``PartitionSpec`` holds it: None,
    one axis name, or a tuple of several."""
    if axes is None:
        return None
    axes = axes if isinstance(axes, tuple) else (axes,)
    return axes[0] if len(axes) == 1 else axes


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

def batch_logical_axes(n_batch: int, mesh) -> Optional[tuple]:
    """Largest batch sharding that divides n_batch:
    (pod,data) > (data,) > None."""
    sizes = mesh_shape(mesh)
    cands = []
    if "pod" in sizes:
        cands.append(("pod", "data"))
    cands.append(("data",))
    for axes in cands:
        ways = 1
        for a in axes:
            ways *= sizes[a]
        if n_batch % ways == 0:
            return axes
    return None


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                device="meta") -> Dict[str, torch.Tensor]:
    """The cell's batch as empty tensors on ``device`` (meta: no
    allocation), the reference's ``ShapeDtypeStruct`` stand-ins."""
    B, S = shape.global_batch, shape.seq_len

    def t(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=device)

    if shape.kind == "decode":
        if cfg.embed_inputs:
            toks = t((B, 1), torch.int32)
        else:
            toks = t((B, 1, cfg.d_model), _dtype(cfg))
        return {"tokens_or_embeds": toks}
    specs: Dict[str, torch.Tensor] = {}
    if cfg.embed_inputs:
        specs["tokens"] = t((B, S), torch.int32)
    else:
        specs["embeds"] = t((B, S, cfg.d_model), _dtype(cfg))
        if cfg.mrope:
            specs["positions"] = t((3, B, S), torch.int32)
    if shape.kind == "train":
        specs["labels"] = t((B, S), torch.int32)
    return specs


def batch_shardings(cfg, shape, mesh, batch_axes_):
    """Spec tuples matching input_specs."""
    b = _entry(batch_axes_)
    out = {}
    for k in input_specs(cfg, shape):
        if k in ("tokens", "labels"):
            out[k] = (b, None)
        elif k == "embeds":
            out[k] = (b, None, None)
        elif k == "positions":
            out[k] = (None, b, None)
        elif k == "tokens_or_embeds":
            out[k] = (b, None) if cfg.embed_inputs else (b, None, None)
    return out


def arch_rules(cfg: ArchConfig, mesh, baxes) -> dict:
    """Per-arch logical-rule fix-ups: a logical axis maps to 'model' only when
    the corresponding dimension divides the mesh axis (e.g. qwen1.5's 20
    heads and every GQA kv=8 fall back to replicated on a 16-way model axis;
    TP then lives on d_ff / vocab / head-flattened dims)."""
    mw = mesh_shape(mesh)["model"]

    def fit(n):
        return ("model",) if n and n % mw == 0 else None

    return {
        "batch": baxes,
        "heads": fit(cfg.n_heads),
        "heads_flat": fit(cfg.n_heads * cfg.hd),  # wo fan-in: flattened H*hd
        "kv_heads": fit(cfg.n_kv_heads),
        "vocab": fit(cfg.vocab),
        "mlp": fit(cfg.d_ff),
        "model": fit(cfg.d_inner if cfg.has_ssm else cfg.d_model),
        "kv_seq": ("model",),
    }


# ---------------------------------------------------------------------------
# named sharding strategies (the reference's hillclimbing levers)
# ---------------------------------------------------------------------------

def strategy_rules(name: str, cfg: ArchConfig, mesh, shape) -> dict:
    """Rule overrides applied on top of arch_rules; 'baseline' is the
    paper-faithful FSDP+TP layout."""
    names = mesh.mesh_dim_names
    all_axes = tuple(a for a in ("pod", "data", "model") if a in names)
    if name == "baseline":
        return {}
    if name == "seqpar":
        # sequence-parallel residual stream: inter-layer activations shard S
        # over the model axis instead of replicating
        return {"seq": ("model",)}
    if name == "fsdp2d":
        # no tensor parallelism: batch over BOTH axes (pure DP), params
        # FSDP-sharded over both axes
        return {
            "batch": all_axes, "fsdp": all_axes,
            "heads": None, "kv_heads": None, "heads_flat": None,
            "vocab": None, "mlp": None, "model": None, "experts": None,
            "kv_seq": None,
        }
    if name == "tponly":
        # decode layout: no FSDP, params sharded over 'model' only
        return {"fsdp": None}
    if name == "ep":
        # expert parallelism: experts over the model axis, no TP inside
        # the expert
        return {"experts": ("model",), "mlp": None}
    if name == "fsdppod":
        # multi-pod: FSDP over BOTH data-parallel axes
        dp = tuple(a for a in ("pod", "data") if a in names)
        return {"fsdp": dp}
    raise ValueError(f"unknown strategy {name}")


def combined_strategy_rules(spec: str, cfg, mesh, shape) -> dict:
    """Comma-separated strategy names, merged left to right."""
    rules: dict = {}
    for name in spec.split(","):
        rules.update(strategy_rules(name.strip(), cfg, mesh, shape))
    return rules


STRATEGIES = ("baseline", "seqpar", "fsdp2d", "tponly", "ep", "fsdppod")


# ---------------------------------------------------------------------------
# per-leaf local (per-device) byte accounting from spec trees
# ---------------------------------------------------------------------------

def _leaf_pairs(tree, specs):
    """(tensor, spec tuple) pairs of a tree of tensors and its spec tree,
    dict keys in sorted order; raises where the structures differ."""
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            have = sorted(specs) if isinstance(specs, dict) else specs
            raise ValueError(f"spec tree keys {have} do not match the "
                             f"tree's {sorted(tree)}")
        for k in sorted(tree):
            yield from _leaf_pairs(tree[k], specs[k])
    elif isinstance(tree, torch.Tensor):
        if not isinstance(specs, tuple) or len(specs) > tree.dim():
            raise ValueError(f"spec {specs!r} for a {tree.dim()}-D leaf")
        yield tree, specs
    else:
        raise TypeError(f"unexpected tree node {type(tree).__name__}")


def local_bytes(tree, spec_tree, mesh) -> int:
    sizes = mesh_shape(mesh)
    total = 0
    for leaf, spec in _leaf_pairs(tree, spec_tree):
        ways = 1
        for entry in spec:
            if entry is None:
                continue
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                ways *= sizes[ax]
        total += leaf.numel() * leaf.element_size() // ways
    return int(total)


def _quantized_specs(params, pspecs):
    """Spec tree matching the quantized param structure: w_int inherits w's
    spec; w_scale keeps the output-channel shards but replicates every axis
    whose size collapsed to 1 (the fan-in axis, which with stacked layer
    params is dim 1, not dim 0)."""
    def visit(p, spec):
        if isinstance(p, dict) and "w_int" in p:
            wspec = spec["w"] if isinstance(spec, dict) and "w" in spec else ()
            wlist = list(wspec) + [None] * (p["w_int"].dim() - len(wspec))
            sshape = p["w_scale"].shape
            sspec = tuple(None if sshape[i] == 1 else wlist[i]
                          for i in range(len(sshape)))
            out = {"w_int": wspec, "w_scale": sspec}
            if "b" in p:
                out["b"] = spec.get("b", ()) if isinstance(spec, dict) else ()
            return out
        if isinstance(p, dict):
            return {k: visit(v, spec[k] if isinstance(spec, dict) else spec)
                    for k, v in p.items()}
        return spec

    return visit(params, pspecs)


# ---------------------------------------------------------------------------
# the traced step (mesh-independent, so shared by both meshes)
# ---------------------------------------------------------------------------

def _abstract_trees(cfg: ArchConfig, shape: ShapeConfig, quant_bits: int):
    """The cell's meta trees: params (quantized for int serve cells), the
    optimizer state (train) or the caches (decode), and the batch."""
    model = Model(cfg)
    params = model.init(None, device="meta")
    if quant_bits < 16 and shape.kind != "train":
        params = model.quantize_params(params, quant_bits)
    trees: Dict[str, Any] = {"params": params,
                             "batch": input_specs(cfg, shape)}
    if shape.kind == "train":
        trees["opt"] = make_optimizer().init(params)
    elif shape.kind == "decode":
        trees["cache"] = model.cache_init(shape.global_batch, shape.seq_len,
                                          device="meta")
    return model, trees


def trace_step(model: Model, shape: ShapeConfig, trees: Dict[str, Any],
               microbatches: int = 1):
    """Run the cell's global step once on ``trees`` under the op-trace
    analysis; returns its ``TraceReport``. The trees may live on any
    device (meta for the dry run; the card to check it)."""
    params, batch = trees["params"], trees["batch"]
    if shape.kind == "train":
        step_fn = make_train_step(model, make_optimizer(),
                                  microbatches=microbatches)
        state = TrainState(params=params, opt=trees["opt"])
        return analyze_call(step_fn, state, batch)[1]
    if shape.kind == "prefill":
        return analyze_call(model.prefill, params, batch)[1]
    cur = torch.zeros((), dtype=torch.int32,
                      device=batch["tokens_or_embeds"].device)
    return analyze_call(model.decode_step, params, trees["cache"],
                        batch["tokens_or_embeds"], cur)[1]


@functools.lru_cache(maxsize=1)
def _traced(cfg: ArchConfig, shape_name: str, quant_bits: int,
            microbatches: int):
    """(model, meta trees, report, build s, trace s) of one cell, kept for
    the next mesh of the same cell."""
    shape = SHAPES[shape_name]
    t0 = obs_timer.now()
    model, trees = _abstract_trees(cfg, shape, quant_bits)
    t1 = obs_timer.now()
    report = trace_step(model, shape, trees, microbatches)
    return model, trees, report, t1 - t0, obs_timer.now() - t1


def ensure_process_group(world_size: int = FAKE_WORLD) -> None:
    """The fake process group of ``world_size`` ranks, unless a group is
    up already."""
    if not dist.is_initialized():
        init_fake_process_group(world_size)


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             rules_override: Optional[dict] = None, quant_bits: int = 16,
             remat: Optional[str] = None, microbatches: int = 1,
             strategy: Optional[str] = None, attn_impl: Optional[str] = None,
             out_dir: str = "artifacts/dryrun", tag: str = "baseline",
             verbose: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "quant_bits": quant_bits,
    }
    if not ok:
        result["status"] = "skipped"
        result["reason"] = reason
        _write(result, out_dir)
        return result

    ensure_process_group()
    mesh = make_production_mesh(multi_pod=multi_pod)
    baxes = batch_logical_axes(shape.global_batch, mesh)
    rules = arch_rules(cfg, mesh, baxes)
    if strategy and strategy != "baseline":
        rules.update(combined_strategy_rules(strategy, cfg, mesh, shape))
    if rules_override:
        rules.update(rules_override)

    try:
        model, trees, report, build_s, trace_s = _traced(
            cfg, shape_name, quant_bits, microbatches)
        params = trees["params"]
        with use_mesh_rules(mesh, rules):
            pspecs = model.param_specs()
            if quant_bits < 16 and shape.kind != "train":
                pspecs = _quantized_specs(params, pspecs)
            params_local = local_bytes(params, pspecs, mesh)
            if shape.kind == "train":
                opt = trees["opt"]
                state_local = (params_local + local_bytes(opt.m, pspecs, mesh)
                               + local_bytes(opt.v, pspecs, mesh))
                result["cache_local_bytes"] = 0
            elif shape.kind == "prefill":
                state_local = params_local
                result["cache_local_bytes"] = 0
            else:  # decode
                state_local = params_local
                result["cache_local_bytes"] = local_bytes(
                    trees["cache"], model.cache_specs(), mesh)
        n_dev = mesh.size()
        stats = report.stats
        result.update(
            status="ok",
            lower_s=round(build_s, 2),
            compile_s=round(trace_s, 2),
            n_devices=n_dev,
            batch_axes=list(baxes) if baxes else [],
            params_local_bytes=params_local,
            state_local_bytes=state_local,
            memory_analysis=report.memory_analysis(),
            xla_cost_analysis={
                "flops": float(stats.flops),
                "bytes_accessed": float(report.bytes_accessed),
            },
            hlo_flops_per_device=float(stats.flops) / n_dev,
            collective_bytes_per_device=None,
            collectives_by_type={},
            collectives_count={},
        )
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({tag}): OK "
                  f"trace={result['compile_s']}s "
                  f"flops/dev={result['hlo_flops_per_device']:.3e} "
                  f"coll B/dev=n/a "
                  f"params/dev={params_local / 2**30:.2f}GiB", flush=True)
            print("  memory_analysis:", result["memory_analysis"], flush=True)
    except Exception as e:  # noqa: BLE001 - a failing cell is a recorded bug
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({tag}): "
                  f"FAILED {result['error']}", flush=True)
    _write(result, out_dir)
    return result


def _write(result: Dict[str, Any], out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    name = (f"{result['arch']}__{result['shape']}__{result['mesh']}"
            f"__{result.get('tag', 'baseline')}.json")
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--quant", type=int, default=16)
    ap.add_argument("--remat", choices=["full", "dots", "dots_saveable",
                                        "none"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--strategy", default=None,
                    help=f"comma-separated from {STRATEGIES}")
    ap.add_argument("--attn-impl", choices=["auto", "naive", "chunked"])
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    rules = {"seq": ("model",)} if args.seq_parallel else None
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    n_ok = n_fail = n_skip = 0
    for arch, shape in cells:
        for mp in meshes:
            if args.skip_existing:
                name = (f"{arch}__{shape}__{'multi' if mp else 'single'}"
                        f"__{args.tag}.json")
                path = os.path.join(args.out, name)
                if os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            continue
            r = run_cell(arch, shape, multi_pod=mp, rules_override=rules,
                         quant_bits=args.quant, remat=args.remat,
                         microbatches=args.microbatches,
                         strategy=args.strategy, attn_impl=args.attn_impl,
                         out_dir=args.out, tag=args.tag)
            n_ok += r["status"] == "ok"
            n_fail += r["status"] == "error"
            n_skip += r["status"] == "skipped"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped (by assignment), "
          f"{n_fail} FAILED", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
