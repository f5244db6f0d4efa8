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

from repro_torch.core.pytree import leaves_with_paths, unflatten_like
from repro_torch.obs import timer as obs_timer

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


def save(directory: str, step: int, tree, extra_meta: Optional[dict] = None):
    """Write one checkpoint atomically."""
    _write(directory, step, _flatten(tree), extra_meta)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, tree_like, step: Optional[int] = None
            ) -> Tuple[Any, int, dict]:
    """Load a checkpoint into the structure of ``tree_like``, each leaf a
    tensor in its stored dtype on the device of ``tree_like``'s tensor at
    the same path. Returns (tree, step, manifest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes = manifest["dtypes"]
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, like in leaves_with_paths(tree_like):
            out.append(_from_host(z[key], dtypes[key], like))
    return unflatten_like(tree_like, out), step, manifest


class CheckpointManager:
    """save-every-N with async write + retention, plus auto-resume."""

    def __init__(self, directory: str, every: int = 100, keep_n: int = 3):
        self.directory = directory
        self.every = every
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, step: int, tree, block: bool = False,
                   extra_meta: Optional[dict] = None, force: bool = False):
        if not force and (step == 0 or step % self.every != 0):
            return False
        self.wait()
        # snapshot on the caller's thread (device -> host copy), write async
        flat = _flatten(tree)

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
        return restore(self.directory, tree_like)
