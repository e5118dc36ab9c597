"""Production meshes and the host's mesh.

``make_production_mesh`` is *abstract*: axis names and sizes, no device
behind them (the JAX package makes 512 placeholder devices for its
dry-run; the port plans on meta tensors and needs none).  It is what the
sharding rules and ``repro_torch.launch.dryrun`` read.

``make_host_mesh`` is a real ``DeviceMesh`` over the host's cards (or,
when asked, its CPU), for DTensors.  It opens a process group of world
size 1 (NCCL on ``cuda``, gloo on ``cpu``, an in-process store: no port,
no network) when none is open, and ``close_host_mesh`` destroys the
group it opened.  Importing this module touches no device and sets no
environment variable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.utils.device import DeviceLike, resolve_device

#: whether make_host_mesh opened the process group (close_host_mesh
#: destroys only that one)
_OPENED = False


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and their sizes, in mesh order."""

    shape: Dict[str, int]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single pod (256 chips) or 2x16x16 (512 chips, 2 pods).

    Axis roles: "pod" × "data" carry data parallelism (gradients reduce
    hierarchically: reduce-scatter within a pod, all-reduce across pods);
    "model" carries TP/EP/sequence sharding.
    """
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return AbstractMesh({"data": 16, "model": 16})


def make_host_mesh(*, model: int = 1, device: DeviceLike = None):
    """A ``DeviceMesh`` with axes ("data", "model") over the process
    group's ranks, one card each (``device=None``: the card; it raises
    without one).  Opens a group of world size 1 when none is open."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    global _OPENED
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        _OPENED = True
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide the {n} ranks")
    return DeviceMesh(dev.type, torch.arange(n).reshape(n // model, model),
                      mesh_dim_names=("data", "model"))


def close_host_mesh() -> None:
    """Destroy the process group ``make_host_mesh`` opened, if it did."""
    import torch.distributed as dist

    global _OPENED
    if _OPENED and dist.is_initialized():
        dist.destroy_process_group()
    _OPENED = False
