"""Device meshes (``repro.launch.mesh`` for the port).

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis is the BHFL edge-server axis, the
slow, straggler-prone link between pods that HieAvg's hierarchy
amortizes.  Each mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the process group, so a mesh needs one: the dry-run
(``launch.dryrun``) starts a fake group of 512 ranks; a sweep over ranks
starts a real one (``gloo``, or ``nccl`` beside a ``gloo`` group for the
sweep's gather).  Where no group is running, ``make_debug_mesh`` and
``make_sweep_mesh`` start a group of one rank in this process.

``mesh_shape`` reads ``{axis: extent}`` from a ``DeviceMesh`` or from any
object whose ``.shape`` is such a mapping, so the sharding rules and the
census can be worked out for a mesh no process group backs.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Roofline constants of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
# power limit; a card set below that limit runs slower under load.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense (NVIDIA H100 80GB HBM3, 700 W)
HBM_BW = 3.35e12                # bytes/s (NVIDIA H100 80GB HBM3, 700 W)
NVLINK_BW = 450e9               # bytes/s each direction, NVLink 4 (18 links;
#                                 NVIDIA H100 80GB HBM3, 700 W)


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _ensure_group(n: int) -> None:
    """A process group of at least ``n`` ranks: the running one, or a
    group of one rank in this process where none runs and ``n`` is 1."""
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs a process group of as many: "
                "start one (torch.distributed.init_process_group) first")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"a mesh of {n} ranks on a process group of "
                           f"{world}")


def _mesh(shape: tuple, names: tuple) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    _ensure_group(n)
    return DeviceMesh(_device_type(), torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1, pod: int = 1
                    ) -> DeviceMesh:
    """A small mesh over the process group's first ranks (tests: one)."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"))
    return _mesh((data, model), ("data", "model"))


def make_sweep_mesh(n_devices: int | None = None) -> DeviceMesh:
    """1-D ``data`` mesh over all (or the first ``n_devices``) ranks of the
    process group.

    The sweep fabric splits a bucket's stacked point axis over ``data``
    (``launch.sharding.SWEEP_RULES``); each rank computes on
    ``cuda:{rank % device_count}``.  On one rank this is a size-1 mesh and
    every bucket runs whole, as without a mesh.
    """
    if n_devices is None:
        _ensure_group(1)
        n_devices = dist.get_world_size()
    return _mesh((n_devices,), ("data",))


def mesh_shape(mesh) -> dict:
    """``{axis name: extent}`` of a ``DeviceMesh`` (whose ``.shape`` is a
    tuple) or of any object whose ``.shape`` is a mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if not isinstance(mesh.shape, Mapping):
        raise TypeError(f"mesh.shape {mesh.shape!r} is not a mapping of "
                        "axis names to extents")
    return dict(mesh.shape)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)
