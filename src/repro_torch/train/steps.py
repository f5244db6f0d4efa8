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

``make_ddp_compressed_step`` and ``init_ddp_state`` (int8-compressed
gradient all-reduce) need ``parallel/collectives.py`` and come with the
parallel slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import leaves, unflatten_like
from repro_torch.models.model import Model
from repro_torch.optim.adamw import Optimizer
from repro_torch.train.loop import TornStateError


class TrainState(NamedTuple):
    params: Any
    opt: Any


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch's arrays as tensors on ``device`` (host arrays are copied)."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v), device=device))
            for k, v in batch.items()}


def _grads(model: Model, params, batch):
    """(loss, metrics, gradients in leaf order) of ``model.loss``."""
    flat = leaves(params)
    for p in flat:
        if not p.requires_grad:
            p.requires_grad_(True)
    loss, metrics = model.loss(params, batch)
    grads = torch.autograd.grad(loss, flat)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(model: Model, optimizer: Optimizer,
                    microbatches: int = 1) -> Callable:
    """The train step. With microbatches > 1, grads are accumulated over
    sequential microbatches (the paper's reuse-factor trade — latency for
    working-set — applied to the training step)."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        device = leaves(state.params)[0].device
        batch = batch_to_device(batch, device)
        if microbatches == 1:
            loss, metrics, flat = _grads(model, state.params, batch)
        else:
            parts = {k: v.reshape(microbatches, -1, *v.shape[1:])
                     for k, v in batch.items()}
            flat = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                    for p in leaves(state.params)]
            lsum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(microbatches):
                loss_i, _, g = _grads(model, state.params,
                                      {k: v[i] for k, v in parts.items()})
                for acc, gi in zip(flat, g):
                    acc.add_(gi)
                del g
                lsum = lsum + loss_i
            for acc in flat:
                acc.div_(microbatches)
            loss = lsum / microbatches
            metrics = {}
        grads = unflatten_like(state.params, flat)
        del flat
        try:
            new_params, new_opt, opt_metrics = optimizer.update(
                grads, state.opt, state.params)
        except Exception as e:     # the update writes the state in place
            raise TornStateError(f"optimizer update failed: {e}") from e
        out = {"loss": loss, **opt_metrics}
        out.update(metrics)
        return TrainState(new_params, new_opt), out

    return train_step


def make_eval_step(model: Model) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        batch = batch_to_device(batch, leaves(params)[0].device)
        loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step
