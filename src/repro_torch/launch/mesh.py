"""Mesh construction over the ranks of the process group.

The counterpart of ``repro.launch.mesh``: a
``torch.distributed.device_mesh.DeviceMesh`` in place of a JAX ``Mesh``,
one process a rank, the reference's axis names and shapes:

    single-pod:  (16, 16)      -> ("data", "model")        256 ranks
    multi-pod :  (2, 16, 16)   -> ("pod", "data", "model") 512 ranks

Functions, not module constants: importing this module touches no
process group. The caller brings the group up first
(``init_process_group``: NCCL for ranks on cards, ``gloo`` on the CPU);
the mesh's device type follows the backend.

``make_elastic_mesh`` builds the best-fitting ("data", "model") mesh from
the ranks that are alive, the reference's clamp: the model axis takes
``min(model_parallel, n)``, lowered until it divides n, and the data axis
the rest, so on one rank every ``model_parallel`` gives (1, 1).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(ranks: Sequence[int], shape: Tuple[int, ...],
          names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(),
                      torch.tensor(list(ranks), dtype=torch.int64).reshape(
                          shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, the process "
                           f"group has {world}")
    return _mesh(range(n), shape, axes)


def elastic_shape(model_parallel: int, n: int) -> Tuple[int, int]:
    """(data, model) of the elastic mesh over ``n`` ranks."""
    mp = max(1, min(model_parallel, n))
    while n % mp != 0:
        mp -= 1
    return n // mp, mp


def make_elastic_mesh(model_parallel: int = 1,
                      ranks: Optional[Sequence[int]] = None):
    """Best ("data", "model") mesh over ``ranks`` (None: every rank of the
    group), the data axis absorbing whatever count remains after TP."""
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    dp, mp = elastic_shape(model_parallel, len(ranks))
    return _mesh(ranks[: dp * mp], (dp, mp), ("data", "model"))


def mesh_devices(mesh) -> int:
    return mesh.size()
