"""Atomic, async checkpoints of trees of tensors, in the reference's
format.

The port of ``repro.checkpoint.checkpoint``. Layout:
``<dir>/step_<n>/arrays.npz`` + ``manifest.json`` (atomic via tmp+rename),
one npz entry per leaf under its "/"-joined path (dict keys, sequence
indices, NamedTuple field names: ``params/blocks/sub0/attn/wq/w``,
``opt/step``, ...), so the port reads the reference's checkpoints of the
same ``TrainState`` tree and the reference reads the port's.

  * **atomic**: a checkpoint is visible only after ``os.replace`` of the
    final directory name — a killed writer never leaves a half
    checkpoint that restore could pick up.
  * **async**: ``CheckpointManager.maybe_save(..., block=False)`` copies
    the tree to host memory on the caller's thread and writes it on a
    background thread.
  * **retention**: only the newest ``keep_n`` checkpoints are kept.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bit pattern,
with dtype ``"bfloat16"`` in the manifest, and restored bit for bit.
``restore`` places each leaf on the device of the target tree's tensor.

Under a mesh (``parallel.sharding.use_mesh_rules``) with the state's spec
tree (``specs``): ``save`` gathers every leaf whole on every rank
(``parallel.sharding.gather_tree``, a collective) and the mesh's first
rank writes it, so the file is the one a single rank would write of the
same state; ``restore`` reads each leaf whole and keeps the rank's block
for the current mesh, whatever mesh wrote it (the counterpart of the
reference's ``restore`` and ``device_put`` onto a new topology). A
blocking save ends at a barrier over the mesh, so every rank then sees
the checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.pytree import leaves_with_paths, unflatten_like
from repro_torch.obs import timer as obs_timer
from repro_torch.parallel.sharding import (active_mesh, gather_tree,
                                           local_block, mesh_group,
                                           mesh_leader, spec_leaves)

BF16 = "bfloat16"


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array, manifest dtype) of one leaf, a copy (the training step
    updates tensors in place while the writer runs); bf16 as uint16
    bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {path: _to_host(leaf) for path, leaf in leaves_with_paths(tree)}


def _from_host(arr: np.ndarray, dtype: str, like) -> Any:
    """A stored array as a tensor on the device of ``like`` (a tensor; on
    the CPU otherwise)."""
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
    return t


def _write(directory: str, step: int, flat: Dict[str, Tuple[np.ndarray, str]],
           extra_meta: Optional[dict] = None) -> None:
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in flat.items()})
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
            "dtypes": {k: d for k, (_, d) in flat.items()},
            "time": obs_timer.walltime(),
        }
        if extra_meta:
            manifest["meta"] = extra_meta
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(directory, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _snapshot(tree, specs):
    """The host copy of ``tree`` that this rank writes: every leaf (whole
    under a mesh with ``specs``), or None on a rank of a mesh that does
    not write."""
    mesh = active_mesh()
    if specs is None or mesh is None:
        return _flatten(tree)
    whole = gather_tree(tree, specs)
    return _flatten(whole) if mesh_leader(mesh) else None


def _barrier(specs) -> None:
    mesh = active_mesh()
    if specs is not None and mesh is not None and mesh.size() > 1:
        dist.barrier(group=mesh_group(mesh))


def save(directory: str, step: int, tree, extra_meta: Optional[dict] = None,
         specs=None):
    """Write one checkpoint atomically (under a mesh with ``specs``: the
    gathered leaves, by the mesh's first rank; every rank returns once it
    is written)."""
    flat = _snapshot(tree, specs)
    if flat is not None:
        _write(directory, step, flat, extra_meta)
    _barrier(specs)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, tree_like, step: Optional[int] = None,
            specs=None) -> Tuple[Any, int, dict]:
    """Load a checkpoint into the structure of ``tree_like``, each leaf a
    tensor in its stored dtype on the device of ``tree_like``'s tensor at
    the same path (under a mesh with ``specs``: the rank's block of the
    stored leaf). Returns (tree, step, manifest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest["dtypes"]
    blocks = (spec_leaves(specs) if specs is not None
              and active_mesh() is not None else None)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, (key, like) in enumerate(leaves_with_paths(tree_like)):
            t = _from_host(z[key], dtypes[key], None)
            if blocks is not None:
                t = local_block(t, blocks[i])
            out.append(t.to(like.device) if isinstance(like, torch.Tensor)
                       else t)
    return unflatten_like(tree_like, out), step, manifest


class CheckpointManager:
    """save-every-N with async write + retention, plus auto-resume; under
    a mesh with the state's spec tree ``specs``, as ``save`` and
    ``restore`` do it."""

    def __init__(self, directory: str, every: int = 100, keep_n: int = 3,
                 specs=None):
        self.directory = directory
        self.every = every
        self.keep_n = keep_n
        self.specs = specs
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, tree, block: bool = False,
                   extra_meta: Optional[dict] = None, force: bool = False):
        if not force and (step == 0 or step % self.every != 0):
            return False
        self.wait()
        # snapshot on the caller's thread (device -> host copy), write async
        flat = _snapshot(tree, self.specs)
        if flat is None:            # a rank of the mesh that does not write
            if block:
                _barrier(self.specs)
            return True

        def work():
            try:
                _write(self.directory, step, flat, extra_meta)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()
            _barrier(self.specs)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(int(n.split("_")[1])
                       for n in os.listdir(self.directory)
                       if n.startswith("step_"))
        for s in steps[: -self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def restore_latest(self, tree_like):
        return restore(self.directory, tree_like, specs=self.specs)
