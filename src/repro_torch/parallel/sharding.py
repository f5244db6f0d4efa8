"""Logical-axis sharding rules over a device mesh.

The counterpart of ``repro.parallel.sharding``. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, one process a rank (NCCL on the card, ``gloo`` for
``device="cpu"``; ``launch.mesh`` builds it), with the reference's axis
names: ``("data", "model")``, or ``("pod", "data", "model")`` for the
multi-pod mesh.

Logical activation / parameter axes map onto mesh axes through
``LOGICAL_RULES``, the reference's table:

    batch        -> (pod, data)     pure DP across pods + data axis
    vocab/heads/mlp/experts -> model   tensor parallelism
    fsdp         -> data            parameter + optimizer-state FSDP
    kv_seq       -> model           sequence-sharded KV cache for decode

``use_mesh_rules`` activates a mesh and rules for the calling thread and
restores the previous ones on exit; rules naming an axis the mesh lacks
(``pod`` on the single-pod mesh) drop that axis. ``logical_to_spec``
gives the reference's ``PartitionSpec`` as a plain tuple, entry by entry
(None, an axis name, or a tuple of names). ``named_sharding`` gives the
``(DeviceMesh, placements)`` pair that
``torch.distributed.tensor.distribute_tensor`` takes. Eager torch has no
layout constraint to apply, so ``shard`` is the identity on the tensor:
under a mesh it checks the logical axes against the tensor and the
active rules.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple, Union

Axis = Union[str, None, Tuple[str, ...]]

# logical axis -> mesh axis (or tuple of mesh axes)
LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "batch_nopod": ("data",),
    "fsdp": ("data",),
    "model": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "heads_flat": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": None,          # experts replicated; TP inside expert (baseline)
    "kv_seq": ("model",),     # decode: sequence-sharded KV cache
    "seq": None,              # activations: sequence replicated (baseline)
    "embed": None,
    "layers": None,           # scan/stack axis of layer params
}


class _State(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(LOGICAL_RULES)


_STATE = _State()


def _axes(v) -> Tuple[str, ...]:
    return v if isinstance(v, tuple) else (v,)


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Optional[dict] = None):
    """Activate a mesh (a ``DeviceMesh`` or None) and logical rules (the
    defaults updated by ``rules``) for model code run inside the block, in
    this thread."""
    prev = (_STATE.mesh, _STATE.rules)
    merged = dict(LOGICAL_RULES)
    if rules:
        merged.update(rules)
    if mesh is not None:
        names = mesh.mesh_dim_names

        def _filter(v):
            if v is None:
                return None
            return tuple(a for a in _axes(v) if a in names) or None

        merged = {k: _filter(v) for k, v in merged.items()}
    _STATE.mesh, _STATE.rules = mesh, merged
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev


def active_mesh():
    return _STATE.mesh


def active_rules() -> dict:
    return _STATE.rules


def logical_to_spec(axes: Sequence[Optional[str]]) -> Tuple[Axis, ...]:
    """A tuple of logical axis names (or None) as the reference's
    PartitionSpec entries: None, one mesh axis, or a tuple of them."""
    out = []
    for a in axes:
        r = None if a is None else _STATE.rules.get(a)
        if r is None:
            out.append(None)
        elif isinstance(r, tuple) and len(r) == 1:
            out.append(r[0])
        else:
            out.append(r)
    return tuple(out)


def shard(x, axes: Sequence[Optional[str]]):
    """The identity. Under a mesh it first checks that ``axes`` has one
    entry a dimension of ``x`` and names only logical axes of the active
    rules (where the reference's ``with_sharding_constraint`` would
    fail on the rank)."""
    if _STATE.mesh is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} logical axes {tuple(axes)} for a "
                         f"{x.dim()}-D tensor")
    unknown = [a for a in axes if a is not None and a not in _STATE.rules]
    if unknown:
        raise KeyError(f"logical axes {unknown} are not in the active rules")
    return x


def named_sharding(axes: Sequence[Optional[str]]):
    """``(mesh, placements)`` for ``distribute_tensor``: ``Shard(d)`` on
    each mesh dimension that the spec gives tensor dimension d,
    ``Replicate()`` on the rest; None without a mesh."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _STATE.mesh
    if mesh is None:
        return None
    placements = [Replicate()] * mesh.ndim
    for d, entry in enumerate(logical_to_spec(axes)):
        if entry is None:
            continue
        for name in _axes(entry):
            placements[mesh.mesh_dim_names.index(name)] = Shard(d)
    return mesh, placements


def mesh_axis_size(name: str) -> int:
    mesh = _STATE.mesh
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def batch_axes() -> Tuple[str, ...]:
    """Concrete mesh axes the batch is sharded over."""
    r = _STATE.rules.get("batch")
    return () if r is None else _axes(r)


def model_axes() -> Tuple[str, ...]:
    r = _STATE.rules.get("model")
    return () if r is None else _axes(r)


def axis_group(mesh, axes: Sequence[str]):
    """The process group over the mesh axes ``axes`` (one or several,
    flattened into one), or None for no axes."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()
