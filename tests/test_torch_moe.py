"""The port's MoE (``repro_torch.models.layers.moe_*``) on the CPU against
the JAX package's ``repro.models.layers`` (its branch without a mesh).

The reference's ``moe_init`` weights are carried across with
``params_from_numpy``; numpy-seeded activations go to both sides, in
float32:

  * ``moe_apply``'s output (within 1e-4, ``TOL``) and Switch aux loss
    (within 1e-6) on reduced grok-1 (top-2 of 4), jamba (top-2 of 4, MoE
    every other layer) and llama4-scout (top-1 of 4 plus the shared
    expert), at a prefill shape and at the 4-slot decode shape, where
    jamba's capacity is 2 a expert and choices drop;
  * the expert choices and which of them drop equal the reference's
    exactly (drops recomputed here in numpy from the choices), with a
    capacity factor low enough that many drop;
  * an exact router tie (two identical router columns): the lower expert
    index wins, as ``jax.lax.top_k`` breaks ties;
  * the dispatch buffer is built by assignment, so ``moe_apply`` runs
    under ``torch.use_deterministic_algorithms(True)`` with the same
    result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models.model import params_from_numpy
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ["grok-1-314b", "jamba-v0.1-52b", "llama4-scout-17b-16e"]


def _pair(name, seed=0, **over):
    jcfg = dataclasses.replace(jget_config(name).reduced(), **over)
    cfg = dataclasses.replace(get_config(name).reduced(), **over)
    jp = jlayers.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       jp), cfg, "cpu")
    return jcfg, jp, cfg, p


def _ref_choices(jcfg, jp, x):
    """The reference's expert choices (top-k of its float32 router)."""
    logits = jnp.asarray(x, jnp.float32) @ jp["router"]["w"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.moe_top_k)
    return np.asarray(idx)


def _kept(idx, E, C):
    """Which of the (T*k) token-major choices fit their expert's C slots."""
    seen = np.zeros(E, np.int64)
    keep = []
    for e in idx.reshape(-1):
        keep.append(seen[e] < C)
        seen[e] += 1
    return np.asarray(keep)


def _check(jcfg, jp, cfg, p, x):
    wy, waux = jlayers.moe_apply(jcfg, jp, jnp.asarray(x))
    y, aux = layers.moe_apply(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    _, _, idx = layers.moe_route(cfg, p, torch.from_numpy(x))
    want_idx = _ref_choices(jcfg, jp, x)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    C = layers.moe_capacity(cfg, x.shape[0] * x.shape[1])
    return _kept(want_idx, cfg.moe_experts, C)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(2, 24), (4, 1)])
def test_moe_matches_reference(name, shape):
    jcfg, jp, cfg, p = _pair(name)
    x = np.random.default_rng(1).standard_normal(
        (*shape, cfg.d_model)).astype(np.float32)
    keep = _check(jcfg, jp, cfg, p, x)
    if name == "jamba-v0.1-52b" and shape == (4, 1):
        # the engine's decode batch: 8 choices for 4 experts of 2 slots
        assert layers.moe_capacity(cfg, 4) == 2
    assert keep.shape == (shape[0] * shape[1] * cfg.moe_top_k,)


@pytest.mark.parametrize("name", NAMES)
def test_moe_drops_the_reference_choices(name):
    """capacity_factor 0.5: each expert takes a quarter of the choices of a
    balanced router, so many drop; outputs and drops equal the
    reference's."""
    jcfg, jp, cfg, p = _pair(name, seed=2, capacity_factor=0.5)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    keep = _check(jcfg, jp, cfg, p, x)
    assert 0 < keep.sum() < keep.size


def test_moe_exact_router_tie_takes_the_lower_index():
    """Router columns 1 and 2 identical: every token's probabilities for
    experts 1 and 2 are equal bit for bit. Columns 0 and 3 are pushed far
    down, so top-1 is always a tie between 1 and 2 and both sides pick 1;
    with top-2 both pick (1, 2) in that order."""
    for k in (1, 2):
        jcfg, jp, cfg, p = _pair("grok-1-314b", seed=4, moe_top_k=k)
        w = np.asarray(jp["router"]["w"]).copy()
        w[:, 2] = w[:, 1]
        w[:, 0] = w[:, 3] = 0.0
        x = np.abs(np.random.default_rng(5).standard_normal(
            (2, 6, cfg.d_model))).astype(np.float32)
        w[:, 1] = w[:, 2] = np.abs(w[:, 1]) + 0.1    # positive logits
        jp = dict(jp, router={"w": jnp.asarray(w)})
        p = dict(p, router={"w": torch.from_numpy(w)})
        probs, _, idx = layers.moe_route(cfg, p, torch.from_numpy(x))
        assert torch.equal(probs[..., 1], probs[..., 2])
        assert (idx[..., 0] == 1).all()
        if k == 2:
            assert (idx[..., 1] == 2).all()
        _check(jcfg, jp, cfg, p, x)


def test_moe_is_the_same_under_deterministic_algorithms():
    jcfg, jp, cfg, p = _pair("jamba-v0.1-52b", seed=6, capacity_factor=0.5)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    want, _ = layers.moe_apply(cfg, p, x)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got, _ = layers.moe_apply(cfg, p, x)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(got, want)
