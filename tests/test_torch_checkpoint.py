"""The port's checkpoints against the JAX package's: one format, both ways.

A ``TrainState`` of the reduced ``internlm2-1.8b`` (float32 params and an
AdamW state after one reference step, so m, v and the int32 step are not
zero) written by the reference is read by the port into its own
``TrainState``, and the reverse: every leaf equal bit for bit, the same
"/"-joined keys (NamedTuple field names included) and manifest. In the
port alone: bf16 leaves round-trip bit for bit as uint16 with manifest
dtype "bfloat16"; atomicity (a torn temporary directory is invisible),
retention, save-every-N, the async writer, overwriting a step, and
``restore`` placing leaves on the target tensors' devices.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.models.model import Model as JModel
from repro.optim.adamw import make_optimizer as jmake_optimizer
from repro.train.steps import TrainState as JTrainState
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint.checkpoint import (CheckpointManager, latest_step,
                                               restore, save)
from repro_torch.configs import get_config
from repro_torch.core.pytree import leaves, leaves_with_paths, tree_map
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, adamw_init
from repro_torch.train.steps import TrainState
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def ref_state():
    """The reference's TrainState after one step, leaves as numpy."""
    cfg = jget_config(ARCH).reduced()
    jm = JModel(cfg)
    opt = jmake_optimizer(base_lr=1e-3, warmup=1, total=10)
    p = jm.init(jax.random.PRNGKey(0))
    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=16).batch(0, 4)
    state, _ = jax.jit(jmake_train_step(jm, opt))(
        JTrainState(p, opt.init(p)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, state)


def _port_like(seed=1):
    p = Model(get_config(ARCH).reduced()).init(
        torch.Generator().manual_seed(seed), device="cpu")
    return TrainState(p, adamw_init(p))


def _ref_paths(tree):
    return ["/".join(jckpt._key_str(k) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_reference_checkpoint_reads_into_the_port(tmp_path, ref_state):
    jckpt.save(str(tmp_path), 1, ref_state)
    like = _port_like()
    state, step, manifest = restore(str(tmp_path), like)
    assert step == 1 and isinstance(state, TrainState)
    assert [k for k, _ in leaves_with_paths(state)] == _ref_paths(ref_state)
    for got, want in zip(leaves(state), jax.tree.leaves(ref_state)):
        assert isinstance(got, torch.Tensor)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 1


def test_port_checkpoint_reads_into_the_reference(tmp_path, ref_state):
    conv = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    state = TrainState(tree_map(conv, ref_state.params),
                       AdamWState(*tree_map(conv, tuple(ref_state.opt))))
    save(str(tmp_path), 3, state)
    want_manifest = tmp_path / "want"
    jckpt.save(str(want_manifest), 3, ref_state)
    got, step, manifest = jckpt.restore(str(tmp_path), ref_state)
    assert step == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with open(want_manifest / "step_0000000003" / "manifest.json") as f:
        ref_manifest = json.load(f)
    for key in ("keys", "shapes", "dtypes"):
        assert manifest[key] == ref_manifest[key]


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "s": {"m": torch.randn(3, generator=g),
                  "step": torch.tensor(4, dtype=torch.int32)}}
    tree["w"][0, 0] = float("-inf")
    save(str(tmp_path), 2, tree)
    path = tmp_path / "step_0000000002"
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["dtypes"] == {"w": "bfloat16", "s/m": "float32",
                                  "s/step": "int32"}
    with np.load(path / "arrays.npz") as z:
        assert z["w"].dtype == np.uint16
    got, step, _ = restore(str(tmp_path), tree)
    assert step == 2 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), tree["w"].view(torch.int16))
    assert torch.equal(got["s"]["m"], tree["s"]["m"])
    assert got["s"]["step"].shape == () and int(got["s"]["step"]) == 4


def test_a_torn_write_is_invisible(tmp_path):
    tree = {"w": torch.ones(2)}
    save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / ".tmp_ckpt_dead")
    (tmp_path / ".tmp_ckpt_dead" / "arrays.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step_0000000009")       # no manifest yet
    assert latest_step(str(tmp_path)) == 1
    assert restore(str(tmp_path), tree)[1] == 1
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "missing"), tree)


def test_manager_retention_every_n_and_async(tmp_path):
    tree = {"w": torch.zeros(64, 64)}
    mgr = CheckpointManager(str(tmp_path / "keep"), every=1, keep_n=2)
    for st in range(1, 6):
        mgr.maybe_save(st, tree, block=True)
    assert sorted(os.listdir(tmp_path / "keep")) == ["step_0000000004",
                                                     "step_0000000005"]
    mgr = CheckpointManager(str(tmp_path / "every"), every=3, keep_n=10)
    assert [mgr.maybe_save(st, tree, block=True) for st in range(1, 8)] == \
        [False, False, True, False, False, True, False]
    mgr = CheckpointManager(str(tmp_path / "async"), every=1)
    assert mgr.maybe_save(1, tree)
    tree["w"] += 1          # the snapshot was taken on the caller's thread
    mgr.wait()
    assert float(restore(str(tmp_path / "async"), tree)[0]["w"].sum()) == 0


def test_overwrite_same_step_and_restore_devices(tmp_path):
    save(str(tmp_path), 5, {"w": torch.zeros(3), "n": np.arange(3)})
    save(str(tmp_path), 5, {"w": torch.ones(3), "n": np.arange(3) + 1})
    got, _, _ = restore(str(tmp_path), {"w": torch.empty(0), "n": None})
    assert torch.equal(got["w"], torch.ones(3))
    assert got["w"].device.type == "cpu"
    # a leaf that is not a tensor in the target comes back on the CPU
    assert torch.equal(got["n"], torch.arange(3) + 1)
