"""Train steps: loss -> grads -> clip -> AdamW, with gradient
accumulation over microbatches.

The port of ``repro.train.steps``'s single-device steps. A step takes a
batch of host (numpy) arrays or tensors, copies it to the parameters'
device, takes the gradients of ``model.loss`` with ``torch.autograd.grad``
(the parameters are marked as requiring grad on the first step) and
updates the state through the optimizer. With ``microbatches > 1`` the
batch is split along its first axis and the microbatches' gradients are
summed in float32 in order, then divided by their count, as the
reference's ``lax.scan`` does.

``make_ddp_compressed_step`` is the explicit data-parallel step with
int8-compressed gradients: the params are replicated on every rank of
the mesh's data axes, each rank takes its slice of the batch, its
gradients go through ``parallel.collectives.compressed_psum_tree`` (error
feedback in ``DDPState.err``), AdamW runs replicated and the loss is
averaged over the data ranks.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pytree import leaves, tree_map, unflatten_like
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, Optimizer
from repro_torch.parallel.collectives import compressed_psum_tree
from repro_torch.parallel.sharding import (active_mesh, active_rules,
                                           axis_group, batch_axes,
                                           mesh_axis_size, spec_axes,
                                           spec_leaves)
from repro_torch.train.loop import TornStateError


class TrainState(NamedTuple):
    params: Any
    opt: Any


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device`` (host arrays are copied)."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v), device=device))
            for k, v in batch.items()}


def _grads(loss_fn: Callable, params, batch):
    """(loss, metrics, gradients in leaf order) of ``loss_fn(params,
    batch) -> (loss, metrics)``."""
    flat = leaves(params)
    for p in flat:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, flat)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def reduce_grads(flat, specs) -> None:
    """The SPMD step's gradient convention (``parallel.collectives``), in
    place on the rank's gradient blocks ``flat`` (leaf order of
    ``specs``, the parameters' spec tree): every rank backpropped its copy
    of the global loss, so over the replica axes (the mesh axes of the
    batch and of "fsdp") a parameter's gradient is summed over the ranks
    that do not split it (those that do got the sum from the FSDP
    gather's backward), then every gradient is divided by the replica
    ranks' count."""
    mesh = active_mesh()
    if mesh is None:
        return
    data_axes = batch_axes() + spec_axes(active_rules().get("fsdp"))
    replica = tuple(a for a in mesh.mesh_dim_names
                    if a in data_axes and mesh_axis_size(a) > 1)
    n = math.prod(mesh_axis_size(a) for a in replica)
    if n == 1:
        return
    for g, spec in zip(flat, spec_leaves(specs)):
        held = {a for e in spec for a in spec_axes(e)}
        over = tuple(a for a in replica if a not in held)
        if over:
            dist.all_reduce(g, group=axis_group(mesh, over))
        g.div_(n)


def step_grads(model: Model, params, batch, microbatches: int = 1,
               specs=None):
    """(loss, metrics, gradients in leaf order) of one step's batch (on
    the parameters' device): ``model.loss``'s gradients, accumulated over
    ``microbatches`` sequential microbatches of the batch's first axis in
    float32 and divided by their count, as the reference's ``lax.scan``
    does; under a mesh reduced by ``reduce_grads`` over ``specs`` (the
    parameters' spec tree)."""
    device = leaves(params)[0].device
    if microbatches == 1:
        loss, metrics, flat = _grads(model.loss, params, batch)
        flat = list(flat)
    else:
        parts = {k: v.reshape(microbatches, -1, *v.shape[1:])
                 for k, v in batch.items()}
        flat = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                for p in leaves(params)]
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(microbatches):
            loss_i, _, g = _grads(model.loss, params,
                                  {k: v[i] for k, v in parts.items()})
            for acc, gi in zip(flat, g):
                acc.add_(gi)
            del g
            lsum = lsum + loss_i
        for acc in flat:
            acc.div_(microbatches)
        loss = lsum / microbatches
        metrics = {}
    if specs is not None:
        reduce_grads(flat, specs)
    return loss, metrics, flat


def make_train_step(model: Model, optimizer: Optimizer,
                    microbatches: int = 1) -> Callable:
    """The train step. With microbatches > 1, grads are accumulated over
    sequential microbatches (the paper's reuse-factor trade — latency for
    working-set — applied to the training step).

    Under a mesh (``parallel.sharding.use_mesh_rules``, read at each
    call) the step is SPMD, one process a rank: the state holds the
    rank's blocks of the parameters and of the optimizer state, as
    ``Model.param_specs`` gives them under the active rules
    (``parallel.sharding.shard_tree``); ``batch`` is the global batch on
    every rank (microbatches split it on axis 0, as the reference's do,
    and the model takes the rank's rows of each); the gradients follow
    ``reduce_grads``, the clipping norm is the global gradient's, and
    ``loss`` and the metrics are the global ones, the same on every
    rank."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        device = leaves(state.params)[0].device
        batch = batch_to_device(batch, device)
        specs = model.param_specs() if active_mesh() is not None else None
        loss, metrics, flat = step_grads(model, state.params, batch,
                                         microbatches, specs)
        grads = unflatten_like(state.params, flat)
        del flat
        new_params, new_opt, opt_metrics = _update(optimizer, grads, state,
                                                   specs)
        out = {"loss": loss, **opt_metrics}
        out.update(metrics)
        return TrainState(new_params, new_opt), out

    return train_step


def _update(optimizer: Optimizer, grads, state, specs=None):
    try:
        return optimizer.update(grads, state.opt, state.params, specs)
    except Exception as e:     # the update writes the state in place
        raise TornStateError(f"optimizer update failed: {e}") from e


def train_state_specs(model: Model) -> TrainState:
    """The spec tree of ``TrainState(params, optimizer.init(params))``
    under the active rules: m and v split as the parameters are, the
    step count whole."""
    p = model.param_specs()
    return TrainState(params=p, opt=AdamWState(step=(), m=p, v=p))


def make_eval_step(model: Model) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        batch = batch_to_device(batch, leaves(params)[0].device)
        loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


# ---------------------------------------------------------------------------
# explicit-DP with compressed gradients
# ---------------------------------------------------------------------------

class DDPState(NamedTuple):
    params: Any
    opt: Any
    err: Any          # error-feedback residuals (float32, per rank)


def make_ddp_compressed_step(loss_fn: Callable, optimizer: Optimizer,
                             mesh, data_axes=("data",)) -> Callable:
    """Params replicated, batch split over ``data_axes`` of ``mesh``: each
    rank takes its contiguous slice of every batch array's first axis
    (the global batch, as the reference's step takes it); per-rank grads
    are all-reduced as int8 with error feedback, then AdamW runs
    replicated. ``loss_fn(params, batch) -> (loss, metrics)``: the rank's
    loss, the mean over its slice. A loss whose graph holds collectives
    (the MoE's mesh branch) must give each rank the gradient whose mean
    over the data group is the global loss's, the convention
    ``models.layers.moe_apply`` states. The model's layers partition
    themselves under the active rules, so a model loss run here must see
    rules that split no parameter (no "fsdp" and no tensor-parallel
    axis of more than one rank): the parameters are whole on every
    rank."""
    group = axis_group(mesh, data_axes)
    axis_size, rank = dist.get_world_size(group), dist.get_rank(group)

    def step(state: DDPState, batch):
        device = leaves(state.params)[0].device
        batch = {k: v.chunk(axis_size)[rank]
                 for k, v in batch_to_device(batch, device).items()}
        loss, _, flat = _grads(loss_fn, state.params, batch)
        mean_grads, new_err = compressed_psum_tree(
            unflatten_like(state.params, flat), state.err, group, axis_size)
        new_params, new_opt, om = _update(optimizer, mean_grads, state)
        dist.all_reduce(loss, group=group)
        return (DDPState(new_params, new_opt, new_err),
                {"loss": loss / axis_size, "grad_norm": om["grad_norm"]})

    return step


def init_ddp_state(params, optimizer: Optimizer) -> DDPState:
    err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    return DDPState(params=params, opt=optimizer.init(params), err=err)
