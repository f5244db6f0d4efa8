"""Block assembly and the layer stack for every family: dense, MoE,
pure mamba and the jamba hybrid.

The counterpart of ``repro.models.transformer``. The stacked parameter
layout is kept: every leaf of ``params["blocks"]`` carries a leading
``n_groups`` axis, as the reference's ``jax.vmap(block_init)`` builds it,
so the reference's weights carry across leaf for leaf. ``stack_apply`` and
``stack_decode`` loop in Python over the groups in place of ``lax.scan``;
``stack_apply`` takes the groups' slices through one ``unbind`` per leaf,
so the backward stacks the groups' gradients once.

Remat (``cfg.remat``, when grad mode is on) maps the reference's
``jax.checkpoint`` policies onto ``torch.utils.checkpoint`` (non-reentrant):
"full" recomputes the whole block in the backward; "dots" keeps the
outputs of the 2-D matrix products (``aten.mm`` / ``addmm``, the
reference's "no batch dims"), and "dots_saveable" those of the batched
ones too (``aten.bmm``), recomputing the rest; "none" keeps everything.
The recompute runs in the backward, on the card on autograd's own
thread, where the caller's thread-local mesh and rules are not active:
the block re-enters the ones of its forward.
A block is ``cfg.block_period`` sublayers, each an attention or mamba
mixer (``cfg.layer_kind``) and a dense or MoE FFN (``cfg.layer_is_moe``);
the aux loss sums over the MoE sublayers.
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
from repro_torch.models import ssm
from repro_torch.models.layers import (mlp_apply, mlp_init, moe_apply,
                                       moe_init, norm_apply, norm_init)
from repro_torch.parallel.sharding import (active_mesh, active_rules,
                                           use_mesh_rules)


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda x: x[g], tree)


# ---------------------------------------------------------------------------
# one block (= block_period sublayers: 1 for dense, 2 for MoE-every-2, 8
# for jamba's 7 mamba + 1 attention with alternating dense / MoE FFNs)
# ---------------------------------------------------------------------------

def sublayer_init(generator, cfg: ArchConfig, i: int, device=None
                  ) -> Dict[str, Any]:
    """Sublayer ``i`` of a block: its norms, its mixer (attention or
    mamba, ``cfg.layer_kind(i)``) and its FFN (MoE or dense,
    ``cfg.layer_is_moe(i)``; none when d_ff is 0)."""
    sub: Dict[str, Any] = {"norm1": norm_init(cfg, device=device)}
    if cfg.layer_kind(i) == "attn":
        sub["attn"] = attn.attn_init(generator, cfg, device=device)
    else:
        sub["ssm"] = ssm.ssm_init(generator, cfg, device=device)
    if cfg.d_ff > 0:
        sub["norm2"] = norm_init(cfg, device=device)
        if cfg.layer_is_moe(i):
            sub["moe"] = moe_init(generator, cfg, device=device)
        else:
            sub["mlp"] = mlp_init(generator, cfg, device=device)
    return sub


def block_apply(cfg: ArchConfig, p, x, positions):
    """Forward through one block. Returns (x, aux_loss), the aux loss
    summed over the block's MoE sublayers (0 without one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.block_period):
        sub = p[f"sub{i}"]
        h = norm_apply(cfg, sub["norm1"], x)
        if cfg.layer_kind(i) == "attn":
            x = x + attn.attn_apply(cfg, sub["attn"], h, positions)
        else:
            x = x + ssm.ssm_apply(cfg, sub["ssm"], h)
        if cfg.d_ff > 0:
            h = norm_apply(cfg, sub["norm2"], x)
            if cfg.layer_is_moe(i):
                y, a = moe_apply(cfg, sub["moe"], h)
                aux = aux + a
            else:
                y = mlp_apply(cfg, sub["mlp"], h)
            x = x + y
    return x, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def block_cache_init(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
                     device=None):
    """Per sublayer: a KV cache (attention) or a conv window and state
    (mamba)."""
    return {f"sub{i}": (attn.attn_cache_init(cfg, batch, max_len, dtype,
                                             device=device)
                        if cfg.layer_kind(i) == "attn" else
                        ssm.ssm_cache_init(cfg, batch, dtype, device=device))
            for i in range(cfg.block_period)}


def block_decode(cfg: ArchConfig, p, x, cache, cur_index):
    """One decode step through one block; the caches are updated in
    place."""
    for i in range(cfg.block_period):
        sub = p[f"sub{i}"]
        h = norm_apply(cfg, sub["norm1"], x)
        if cfg.layer_kind(i) == "attn":
            mixed, _ = attn.attn_decode(cfg, sub["attn"], h,
                                        cache[f"sub{i}"], cur_index)
        else:
            mixed, _ = ssm.ssm_decode(cfg, sub["ssm"], h, cache[f"sub{i}"])
        x = x + mixed
        if cfg.d_ff > 0:
            h = norm_apply(cfg, sub["norm2"], x)
            if cfg.layer_is_moe(i):
                y, _ = moe_apply(cfg, sub["moe"], h)
            else:
                y = mlp_apply(cfg, sub["mlp"], h)
            x = x + y
    return x, cache


# ---------------------------------------------------------------------------
# stack (loop over groups)
# ---------------------------------------------------------------------------

def stack_init(generator, cfg: ArchConfig, device=None):
    """Every group's block, stacked leaf by leaf along a leading
    ``n_groups`` axis, each block ``sub0`` .. ``sub{block_period - 1}``.
    Drawn sublayer by sublayer (groups outer) straight into the stacked
    tensors, so at most one sublayer is alive beside them: a jamba block
    is 8 sublayers, a third of a 16-layer model."""
    stacked: Dict[str, Any] = {}
    for g in range(cfg.n_groups):
        for i in range(cfg.block_period):
            sub = sublayer_init(generator, cfg, i, device=device)
            if g == 0:
                stacked[f"sub{i}"] = tree_map(
                    lambda x: torch.empty((cfg.n_groups, *x.shape),
                                          dtype=x.dtype, device=x.device),
                    sub)
            tree_map(lambda dst, src: dst[g].copy_(src), stacked[f"sub{i}"],
                     sub)
            del sub
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


def _under(mesh, rules, fn, *args):
    with use_mesh_rules(mesh, rules):
        return fn(*args)


def _remat(cfg: ArchConfig, fn):
    """``fn`` under the config's remat policy (the identity without grad
    mode, where there is no backward to recompute for), run with the mesh
    and rules active at its call, in the forward and the recompute."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kwargs = {"use_reentrant": False}
    if cfg.remat in _SAVED_PRODUCTS:
        policy = functools.partial(_keep_products,
                                   _SAVED_PRODUCTS[cfg.remat])
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    def run(*args):
        return checkpoint(functools.partial(_under, active_mesh(),
                                            active_rules(), fn),
                          *args, **kwargs)

    return run


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
