"""AdamW + gradient clipping + cosine LR schedule over trees of tensors.

The port of ``repro.optim.adamw``. The optimizer state (m, v in float32)
mirrors the parameters' tree; m, v, the step counter and the parameters
are updated in place (``adamw_update`` returns the same tensors), which
keeps a full-width state to one copy on the card. The arithmetic keeps the
reference's op order and roundings: every product and sum is its own
float32 op (no ``alpha=`` or ``addcmul``, which would fuse a multiply-add),
the bias corrections are float32 powers of the step, and the update is
computed in float32 and rounded once to the parameter's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.pytree import leaves, tree_map, unflatten_like
from repro_torch.parallel.sharding import (active_mesh, axis_group,
                                           spec_axes, spec_leaves)


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=zeros, v=tree_map(torch.clone, zeros))


def _sumsq(g: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(g.to(torch.float32)))


def _global_sumsq(grads, specs) -> torch.Tensor:
    """The squared norm of the whole gradient of which ``grads`` holds the
    rank's blocks under the active mesh: each leaf's squares summed over
    the groups that split it (the leaves split alike summed together, one
    all-reduce a group), a leaf no group splits counted once."""
    mesh = active_mesh()
    by_axes = {}
    for g, spec in zip(leaves(grads), spec_leaves(specs)):
        axes = tuple(a for a in mesh.mesh_dim_names
                     if any(a in spec_axes(e) for e in spec))
        by_axes.setdefault(axes, []).append(_sumsq(g))
    total = None
    for axes, parts in by_axes.items():
        part = sum(parts)
        if axes:
            dist.all_reduce(part, group=axis_group(mesh, axes))
        total = part if total is None else total + part
    return total


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, specs=None):
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own dtype, and the norm before scaling). ``specs`` (the gradients'
    spec tree) under a mesh: ``grads`` are the rank's blocks and the norm
    is the whole gradient's."""
    mesh = active_mesh()
    if specs is None or mesh is None or mesh.size() == 1:
        # a mesh of one rank splits nothing: the meshless sum, in leaf
        # order (GSPMD does nothing on a one-device axis)
        gn = torch.sqrt(sum(_sumsq(g) for g in leaves(grads)))
    else:
        gn = torch.sqrt(_global_sumsq(grads, specs))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, AdamWState]:
    """One AdamW step. m, v, the parameters and the step counter are
    updated in place and returned, so a compiled step's state is the one
    set of tensors it was given (the reference's donated state)."""
    step = state.step.add_(1)
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    flat_p = leaves(params)
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          flat_p):
        gf = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * torch.square(gf))
        del gf
        denom = torch.sqrt(v / bc2).add_(eps)
        delta = (m / bc1).div_(denom)
        del denom
        pf = p.to(torch.float32)
        delta.add_(weight_decay * pf)
        p.copy_((pf - lr * delta).to(p.dtype))
        del pf, delta
    return (unflatten_like(params, flat_p),
            AdamWState(step=step, m=state.m, v=state.v))


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm,
                           torch.clamp_min(cos, 0.1 * base_lr))

    return lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    lr_fn: Callable
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        return adamw_init(params)

    def update(self, grads, state, params, specs=None):
        """One step; under a mesh ``specs`` is the parameters' spec tree
        (the global norm's groups): AdamW itself is elementwise, so it
        runs on the rank's blocks as it is."""
        grads, gn = clip_by_global_norm(grads, self.max_grad_norm, specs)
        lr = self.lr_fn(state.step + 1)
        new_p, new_s = adamw_update(
            grads, state, params, lr,
            b1=self.b1, b2=self.b2, weight_decay=self.weight_decay,
        )
        return new_p, new_s, {"grad_norm": gn, "lr": lr}


def make_optimizer(base_lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000, max_grad_norm: float = 1.0,
                   weight_decay: float = 0.1) -> Optimizer:
    return Optimizer(lr_fn=cosine_schedule(base_lr, warmup, total),
                     max_grad_norm=max_grad_norm, weight_decay=weight_decay)
