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
    seq          -> None            the residual stream's sequence
                                    (model under the seqpar strategy)

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

The SPMD form, one process a rank: the model code partitions itself
(``models.layers``, ``models.attention``, ``models.model``), reading the
active rules through ``logical_group`` (the process group that splits a
logical axis), ``logical_block`` (the rank's block index along it) and
``local_dim`` (the rank-local size of a dimension); ``sequence_group``
is the group over which the residual stream of a sequence is split, and
``same_split`` tells whether two logical axes split over the same mesh
axes (so that a sequence gather can be the entry of a tensor-parallel
computation). A rank holds the
blocks that the spec trees give: ``local_block`` is the rank's
contiguous block of a full tensor under a spec, in rank order along each
split dimension (JAX's ``NamedSharding`` block layout: a dimension split
over several mesh axes is split row-major over them); ``shard_tree``
takes every leaf's block and ``gather_tree`` all-gathers every leaf
whole again over the groups that split it. A spec tree holds a spec
tuple where the data tree holds a tensor.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

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
    flattened into one; axes of one rank among several are left out), or
    None for no axes. A group over every axis of the mesh is the one
    ``launch.mesh`` made with it (creating a group is a collective of
    every rank of the process group)."""
    axes = tuple(axes)
    if len(axes) > 1:
        axes = tuple(a for a in axes if _size(mesh, a) > 1) or axes[:1]
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if axes == tuple(mesh.mesh_dim_names):
        return mesh._flatten().get_group()
    return mesh[axes]._flatten().get_group()


# ---------------------------------------------------------------------------
# the SPMD form: groups, blocks and trees of blocks
# ---------------------------------------------------------------------------

def _size(mesh, name: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(name)))


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    return () if entry is None else _axes(entry)


def _block(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(this rank's block index, block count) along mesh ``axes``,
    row-major over them."""
    index, count = 0, 1
    for a in axes:
        n = _size(mesh, a)
        index, count = index * n + mesh.get_local_rank(a), count * n
    return index, count


def logical_group(name: str):
    """The process group over the mesh axes that the active rules give
    the logical axis ``name``; None without a mesh, without such axes, or
    when they hold one rank (nothing is split, no collective runs)."""
    mesh, r = _STATE.mesh, _STATE.rules.get(name)
    if mesh is None or r is None:
        return None
    axes = _axes(r)
    if math.prod(_size(mesh, a) for a in axes) == 1:
        return None
    return axis_group(mesh, axes)


def sequence_group(seq_len: int):
    """The group over which the residual stream of a ``seq_len``-token
    sequence is split into blocks (the "seq" rule, the seqpar
    strategy); None where the rules leave it whole, or where ``seq_len``
    does not split into the group's blocks (a one-token decode step)."""
    group = logical_group("seq")
    if group is None or seq_len % dist.get_world_size(group):
        return None
    return group


def same_split(a: str, b: str) -> bool:
    """Whether the logical axes ``a`` and ``b`` split over the same mesh
    axes under the active rules (both split)."""
    ra, rb = _STATE.rules.get(a), _STATE.rules.get(b)
    return ra is not None and _axes(ra) == _axes(rb or ())


def spec_group(entry, mesh=None):
    """The process group over the mesh axes of one spec entry; None
    where they hold one rank (or without a mesh)."""
    mesh = mesh if mesh is not None else _STATE.mesh
    axes = spec_axes(entry)
    if mesh is None or _block(mesh, axes)[1] == 1:
        return None
    return axis_group(mesh, axes)


def logical_block(name: str) -> Tuple[int, int]:
    """(this rank's block index, block count) along the logical axis
    ``name``: (0, 1) where it is not split."""
    mesh, r = _STATE.mesh, _STATE.rules.get(name)
    if mesh is None or r is None:
        return 0, 1
    return _block(mesh, _axes(r))


def local_dim(name: str, n: int) -> int:
    """The rank-local size of a dimension of ``n`` along the logical axis
    ``name`` (heads, kv heads, d_ff, vocab) under the active rules."""
    count = logical_block(name)[1]
    if n % count:
        raise ValueError(f"{name}: {n} does not split into {count} blocks")
    return n // count


def local_block(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """This rank's contiguous block of the full tensor ``x`` under the
    spec tuple ``spec`` (one entry a dimension; a shorter spec leaves the
    rest whole), a fresh tensor; ``mesh`` None: the active one (without
    one, a copy of ``x``)."""
    mesh = mesh if mesh is not None else _STATE.mesh
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} for a {x.dim()}-D tensor")
    if mesh is not None:
        for d, entry in enumerate(spec):
            index, count = _block(mesh, spec_axes(entry))
            if count == 1:
                continue
            if x.shape[d] % count:
                raise ValueError(f"dimension {d} of {tuple(x.shape)} does "
                                 f"not split into {count} blocks ({spec})")
            n = x.shape[d] // count
            x = x.narrow(d, index * n, n)
    return x.clone(memory_format=torch.contiguous_format)


def local_shape(shape: Sequence[int], spec, mesh=None) -> Tuple[int, ...]:
    """The shape of this rank's block of a tensor of ``shape`` under the
    spec tuple ``spec`` (``local_block``'s, without the tensor)."""
    mesh = mesh if mesh is not None else _STATE.mesh
    out = list(shape)
    if mesh is not None:
        for d, entry in enumerate(spec):
            count = _block(mesh, spec_axes(entry))[1]
            if out[d] % count:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split into {count} blocks ({spec})")
            out[d] //= count
    return tuple(out)


def batch_block(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a global batch array along ``dim`` (the
    logical "batch" axis); ``x`` itself where the batch is not split."""
    spec = logical_to_spec((None,) * dim + ("batch",))
    if _STATE.mesh is None or _block(_STATE.mesh,
                                     spec_axes(spec[dim]))[1] == 1:
        return x
    return local_block(x, spec)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over the leaves of ``tree`` (dicts, lists,
    tuples, NamedTuples of tensors), ``specs`` holding a spec tuple at
    each leaf's place; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], specs[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        items = [map_specs(fn, t, s) for t, s in zip(tree, specs)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, specs)


def spec_leaves(specs) -> list:
    """The spec tuples of a spec tree in the data tree's leaf order (dict
    keys sorted, NamedTuple fields in order; a plain tuple is a spec)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if hasattr(specs, "_fields"):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def shard_tree(tree, specs, mesh=None):
    """Every leaf's block (``local_block``) under its spec."""
    return map_specs(lambda x, s: local_block(x, s, mesh), tree, specs)


def gather_leaf(x: torch.Tensor, spec, mesh=None) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block under
    ``spec``: all-gathered over the group of each split dimension (every
    rank of the mesh must call it). Not differentiable."""
    mesh = mesh if mesh is not None else _STATE.mesh
    if mesh is None:
        return x
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if _block(mesh, axes)[1] == 1:
            continue
        group = axis_group(mesh, axes)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim=d)
    return x


def gather_tree(tree, specs, mesh=None):
    """``shard_tree``'s inverse: every leaf whole on every rank."""
    return map_specs(lambda x, s: gather_leaf(x, s, mesh), tree, specs)


def quantized_specs(params, pspecs):
    """The spec tree of ``Model.quantize_params``' tree, from the float
    tree's ``pspecs``: ``w_int`` takes ``w``'s spec; ``w_scale`` keeps
    its output-channel entries and replicates every axis of size 1 (the
    fan-in axis: dim 1 of a stacked leaf, dim 0 of the head); a bias
    keeps its own. The reference's ``dryrun._quantized_specs``."""
    def visit(p, spec):
        if isinstance(p, dict) and "w_int" in p:
            wspec = spec["w"] if isinstance(spec, dict) and "w" in spec else ()
            wlist = list(wspec) + [None] * (p["w_int"].dim() - len(wspec))
            sshape = p["w_scale"].shape
            sspec = tuple(None if sshape[i] == 1 else wlist[i]
                          for i in range(len(sshape)))
            out = {"w_int": wspec, "w_scale": sspec}
            if "b" in p:
                out["b"] = spec.get("b", ()) if isinstance(spec, dict) else ()
            return out
        if isinstance(p, dict):
            return {k: visit(v, spec[k] if isinstance(spec, dict) else spec)
                    for k, v in p.items()}
        return spec

    return visit(params, pspecs)


def mesh_group(mesh):
    """The process group over every rank of ``mesh``."""
    return axis_group(mesh, mesh.mesh_dim_names)


def mesh_leader(mesh) -> bool:
    """Whether this rank is the mesh's first (the one that writes)."""
    return all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names)
