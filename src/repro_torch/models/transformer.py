"""Block assembly and the layer stack, attention blocks only.

The counterpart of ``repro.models.transformer``. The stacked parameter
layout is kept: every leaf of ``params["blocks"]`` carries a leading
``n_groups`` axis, as ``jax.vmap(block_init)`` builds it, so the
reference's weights carry across leaf for leaf. ``stack_apply`` and
``stack_decode`` loop in Python over the groups in place of ``lax.scan``.
Remat is training only and is left out; SSM and MoE blocks are not ported
(``layers.check_supported``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (check_supported, mlp_apply, mlp_init,
                                       norm_apply, norm_init)


def map_tree(fn, *trees):
    """Apply ``fn`` leaf by leaf over nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _group(tree, g: int):
    """Group ``g``'s slice of a stacked tree (views, no copy)."""
    return map_tree(lambda x: x[g], tree)


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
    """Forward through one block."""
    for i in range(cfg.block_period):
        sub = p[f"sub{i}"]
        h = norm_apply(cfg, sub["norm1"], x)
        x = x + attn.attn_apply(cfg, sub["attn"], h, positions)
        if cfg.d_ff > 0:
            h = norm_apply(cfg, sub["norm2"], x)
            x = x + mlp_apply(cfg, sub["mlp"], h)
    return x


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
            stacked = map_tree(lambda x: torch.empty((cfg.n_groups, *x.shape),
                                                 dtype=x.dtype,
                                                 device=x.device), blk)
        map_tree(lambda dst, src: dst[g].copy_(src), stacked, blk)
        del blk
    return stacked


def stack_apply(cfg: ArchConfig, stacked, x, positions):
    """Forward through all groups."""
    for g in range(cfg.n_groups):
        x = block_apply(cfg, _group(stacked, g), x, positions)
    return x


def stack_decode(cfg: ArchConfig, stacked, caches, x, cur_index):
    """Decode step through all groups. Returns (x, caches), the stacked
    caches updated in place."""
    for g in range(cfg.n_groups):
        x, _ = block_decode(cfg, _group(stacked, g), x, _group(caches, g),
                            cur_index)
    return x, caches
