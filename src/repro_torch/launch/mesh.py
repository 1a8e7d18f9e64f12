"""Device meshes (port of ``repro.launch.mesh``) as
``torch.distributed.device_mesh.DeviceMesh``.

Defined as functions, so importing this module starts no process group.
``make_production_mesh`` wants a world of exactly 256 or 512 ranks: the dry
run (``launch/dryrun.py``) starts one on the ``fake`` backend first.
``make_host_mesh`` covers what this process has, one device, and starts the
world of one it needs when none exists: an in-process ``HashStore`` (no
network), NCCL on ``cuda``, gloo on ``cpu``. A group that already exists
with another backend or world size is refused, never reused.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import DEFAULT_DEVICE

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _ensure_process_group(device_type: str, world_size: int = 1) -> None:
    """Start a single-process group of ``world_size`` 1 for ``device_type``
    when none exists; check an existing one's backend and world size."""
    backend = BACKENDS[device_type]
    if dist.is_initialized():
        have = (dist.get_backend(), dist.get_world_size())
        if have[0] not in (backend, "fake") or have[1] != world_size:
            raise RuntimeError(f"a process group ({have[0]}, world {have[1]}) already "
                               f"exists; this mesh wants ({backend}, world {world_size})")
        return
    if world_size != 1:
        raise RuntimeError(f"no process group: start one of {world_size} ranks first")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the current world, which must
    hold exactly ``prod(shape)`` ranks (a world of one is started if none
    exists). ``device`` defaults to ``cuda``."""
    device_type = torch.device(device if device is not None else DEFAULT_DEVICE).type
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    _ensure_process_group(device_type, n)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[str] = None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``. Raises ``ValueError`` unless the world
    already has 256 (512) ranks, as ``repro``'s refuses with fewer devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; the world "
                         f"has {have}")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: Optional[str] = None) -> DeviceMesh:
    """What this process has: a (1, 1) ``("data", "model")`` mesh on
    ``device`` (default ``cuda``)."""
    return make_mesh((1, 1), ("data", "model"), device)


def mesh_device_count(mesh) -> int:
    """The number of devices of a ``DeviceMesh`` (or of anything whose
    ``shape`` maps axis names to extents)."""
    shape = mesh.shape
    return math.prod(shape.values() if hasattr(shape, "values") else shape)
