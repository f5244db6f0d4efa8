"""Block assembly and the layer stack, attention blocks only.

The counterpart of ``repro.models.transformer``. The stacked parameter
layout is kept: every leaf of ``params["blocks"]`` carries a leading
``n_groups`` axis, as ``jax.vmap(block_init)`` builds it, so the
reference's weights carry across leaf for leaf. ``stack_apply`` and
``stack_decode`` loop in Python over the groups in place of ``lax.scan``;
``stack_apply`` takes the groups' slices through one ``unbind`` per leaf,
so the backward stacks the groups' gradients once.

Remat (``cfg.remat``, when grad mode is on) maps the reference's
``jax.checkpoint`` policies onto ``torch.utils.checkpoint`` (non-reentrant):
"full" recomputes the whole block in the backward; "dots" keeps the
outputs of the 2-D matrix products (``aten.mm`` / ``addmm``, the
reference's "no batch dims"), and "dots_saveable" those of the batched
ones too (``aten.bmm``), recomputing the rest; "none" keeps everything.
SSM and MoE blocks are not ported (``layers.check_supported``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.core.pytree import leaves, tree_map, unflatten_like
from repro_torch.models import attention as attn
from repro_torch.models.layers import (check_supported, mlp_apply, mlp_init,
                                       norm_apply, norm_init)


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda x: x[g], tree)


# ---------------------------------------------------------------------------
# one block (= block_period sublayers; 1 for the dense configs)
# ---------------------------------------------------------------------------

def block_init(generator, cfg: ArchConfig, device=None) -> Dict[str, Any]:
    check_supported(cfg)
    p: Dict[str, Any] = {}
    for i in range(cfg.block_period):
        sub: Dict[str, Any] = {"norm1": norm_init(cfg, device=device),
                               "attn": attn.attn_init(generator, cfg,
                                                      device=device)}
        if cfg.d_ff > 0:
            sub["norm2"] = norm_init(cfg, device=device)
            sub["mlp"] = mlp_init(generator, cfg, device=device)
        p[f"sub{i}"] = sub
    return p


def block_apply(cfg: ArchConfig, p, x, positions):
    """Forward through one block. Returns (x, aux_loss); the aux loss is
    MoE's and 0 for the dense blocks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.block_period):
        sub = p[f"sub{i}"]
        h = norm_apply(cfg, sub["norm1"], x)
        x = x + attn.attn_apply(cfg, sub["attn"], h, positions)
        if cfg.d_ff > 0:
            h = norm_apply(cfg, sub["norm2"], x)
            x = x + mlp_apply(cfg, sub["mlp"], h)
    return x, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def block_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
                     device=None):
    check_supported(cfg)
    return {f"sub{i}": attn.attn_cache_init(cfg, batch, max_len, dtype,
                                            device=device)
            for i in range(cfg.block_period)}


def block_decode(cfg: ArchConfig, p, x, cache, cur_index):
    """One decode step through one block; the cache is updated in place."""
    for i in range(cfg.block_period):
        sub = p[f"sub{i}"]
        h = norm_apply(cfg, sub["norm1"], x)
        mixed, _ = attn.attn_decode(cfg, sub["attn"], h, cache[f"sub{i}"],
                                    cur_index)
        x = x + mixed
        if cfg.d_ff > 0:
            h = norm_apply(cfg, sub["norm2"], x)
            x = x + mlp_apply(cfg, sub["mlp"], h)
    return x, cache


# ---------------------------------------------------------------------------
# stack (loop over groups)
# ---------------------------------------------------------------------------

def stack_init(generator, cfg: ArchConfig, device=None):
    """Every group's block, stacked leaf by leaf along a leading
    ``n_groups`` axis. Built one group at a time into the stacked tensors,
    so at most one unstacked block is alive beside them."""
    stacked = None
    for g in range(cfg.n_groups):
        blk = block_init(generator, cfg, device=device)
        if stacked is None:
            stacked = tree_map(lambda x: torch.empty((cfg.n_groups, *x.shape),
                                                 dtype=x.dtype,
                                                 device=x.device), blk)
        tree_map(lambda dst, src: dst[g].copy_(src), stacked, blk)
        del blk
    return stacked


#: the matrix products whose outputs each selective policy keeps
_SAVED_PRODUCTS = {
    "dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
    "dots_saveable": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default),
}


def _keep_products(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, fn):
    """``fn`` under the config's remat policy (the identity without grad
    mode, where there is no backward to recompute for)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat in _SAVED_PRODUCTS:
        policy = functools.partial(_keep_products,
                                   _SAVED_PRODUCTS[cfg.remat])
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       policy)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=context_fn)
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _unstack(stacked, n: int):
    """The ``n`` groups' parameter trees, each leaf one ``unbind`` slice."""
    per = [x.unbind(0) for x in leaves(stacked)]
    return [unflatten_like(stacked, [p[g] for p in per]) for g in range(n)]


def stack_apply(cfg: ArchConfig, stacked, x, positions):
    """Forward through all groups, each block under ``cfg.remat``. Returns
    (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat(cfg, functools.partial(block_apply, cfg))
    for p in _unstack(stacked, cfg.n_groups):
        x, a = block(p, x, positions)
        aux = aux + a
    return x, aux


def stack_decode(cfg: ArchConfig, stacked, caches, x, cur_index):
    """Decode step through all groups. Returns (x, caches), the stacked
    caches updated in place."""
    for g in range(cfg.n_groups):
        x, _ = block_decode(cfg, _group(stacked, g), x, _group(caches, g),
                            cur_index)
    return x, caches
