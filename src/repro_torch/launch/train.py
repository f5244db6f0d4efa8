"""Training launcher: mesh construction, the train step, the synthetic
token stream and the fault-tolerant loop with elastic restart. The port
of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch internlm2-1.8b --reduced \
        --steps 50 --batch 8 --seq 64 --device cpu

Everything runs on the card unless ``--device cpu`` is given; asking for
the card without one raises. The mesh is ``launch.mesh.make_elastic_mesh
(--model-parallel)`` over the ranks of the process group, and the loop
runs under ``parallel.sharding.use_mesh_rules(mesh)``. Run as a plain
process, the launcher brings up a group of one rank itself (NCCL on the
card, ``gloo`` on the CPU, an in-memory store: no address, no port) and
takes it down at the end; the mesh is then (1, 1) whatever
``--model-parallel`` says, as the reference's launcher gives on one
device. A group that is already up (the caller's: N processes, each
calling ``main`` after its own ``init_process_group``) is used as it is,
and the step is SPMD over its ranks: under ``launch.dryrun.arch_rules``
of the mesh (a logical axis goes to "model" only where its dimension
divides the axis; the batch over the largest of ("data",) that divides
``--batch``), every rank draws the same seeded weights, keeps its blocks
of them (``parallel.sharding.shard_tree`` over ``Model.param_specs``)
and of the optimizer state, takes its rows of each global batch, and the
checkpoints gather and reshard (``train.steps.make_train_step``,
``checkpoint``), for every family: dense, MoE, mamba and the hybrid
blocks. The step is a ``core.programs.StepProgram``, as the reference
jits it with the state donated: on one rank on the card, one CUDA graph
per batch shape that updates the state's own tensors; over a mesh of
more than one rank it runs eagerly (the log says which). Weights come from a ``torch.Generator``
seeded with 0 (JAX's PRNG is not reproduced). A run resumes from the
newest checkpoint in ``--ckpt-dir``; on ``ElasticRestart`` (the
straggler watchdog, taken by every rank alike) the launcher builds the
mesh again over the group's ranks (no failure detector hands back a
smaller set, as in the reference), builds the state again and resumes
from the checkpoint the loop wrote, resharded onto the mesh. ``--arch``
takes every configuration; the vlm / audio backbones (``embed_inputs=False``),
whose frontends are stubs, train on seeded normal frame embeddings (one
draw a step, so a resumed run sees the same batches) against the token
stream's labels.
"""

import argparse
import dataclasses
import logging
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.programs import StepProgram
from repro_torch.core.qir import resolve_device
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.launch.dryrun import arch_rules, batch_logical_axes
from repro_torch.launch.mesh import make_elastic_mesh, mesh_devices
from repro_torch.models.model import Model
from repro_torch.optim.adamw import make_optimizer
from repro_torch.parallel.sharding import shard_tree, use_mesh_rules
from repro_torch.train.loop import ElasticRestart, LoopConfig, run_training
from repro_torch.train.steps import (TrainState, make_train_step,
                                     train_state_specs)

logging.basicConfig(level=logging.INFO, format="%(message)s")
log = logging.getLogger("repro_torch.launch.train")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-scale same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quant-bits", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--max-elastic-restarts", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.quant_bits < 16:
        cfg = dataclasses.replace(cfg, weight_bits=args.quant_bits)
    device = resolve_device(args.device)

    own_group = not dist.is_initialized()
    if own_group:
        if device.type == "cuda":       # NCCL's communicator takes this card
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    try:
        return _train(args, cfg, device)
    finally:
        if own_group:
            dist.destroy_process_group()


def _step_program(step, device, mesh):
    """The train step as the reference's donated jit program: a
    ``StepProgram`` (on the card one CUDA graph per batch shape over the
    state's own tensors). Over a mesh of more than one rank the step runs
    through the program's ``eager``: a graph cannot hold the mesh's
    ``gloo`` collectives."""
    prog = StepProgram(step, device, name="train_step")
    if mesh.size() > 1:
        log.info("train step: eager over the mesh's %d ranks (a CUDA graph "
                 "cannot hold their collectives)", mesh.size())
        return prog.eager
    log.info("train step: %s", "a CUDA graph program, state donated"
             if device.type == "cuda" else f"eager on {device}")
    return prog


def _train(args, cfg, device):
    data = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq)
    restarts = 0
    while True:
        mesh = make_elastic_mesh(args.model_parallel)
        log.info("mesh %s over %d ranks", dict(zip(
            mesh.mesh_dim_names, mesh.shape)), mesh_devices(mesh))
        rules = arch_rules(cfg, mesh, batch_logical_axes(args.batch, mesh))
        log.info("%s on %s", cfg.name, device)
        model = Model(cfg)
        opt = make_optimizer(base_lr=3e-4, warmup=10, total=args.steps)
        with use_mesh_rules(mesh, rules):
            specs = train_state_specs(model)
            params = shard_tree(model.init(
                torch.Generator(device=device).manual_seed(0),
                device=device), specs.params)
        state = TrainState(params=params, opt=opt.init(params))
        step_fn = _step_program(make_train_step(
            model, opt, microbatches=args.microbatches), device, mesh)

        def batch_fn(step):
            # host arrays; the step copies them to the device
            b = data.batch(step, args.batch)
            if cfg.embed_inputs:
                return b
            frames = np.random.default_rng(step).standard_normal(
                (*b["labels"].shape, cfg.d_model), dtype=np.float32)
            return {"embeds": frames, "labels": b["labels"]}

        lcfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, log_every=10)
        try:
            with use_mesh_rules(mesh, rules):
                res = run_training(step_fn, state, batch_fn, lcfg,
                                   state_specs=specs)
            break
        except ElasticRestart as e:
            restarts += 1
            log.warning("elastic restart %d: %s", restarts, e)
            if restarts > args.max_elastic_restarts:
                raise
            # the group's ranks again, resumed from the checkpoint
            continue

    last = res.metrics_history[-1] if res.metrics_history else {}
    log.info("finished at step %d (resumed_from=%s): %s",
             res.final_step, res.resumed_from, last)
    return res


if __name__ == "__main__":
    main()
