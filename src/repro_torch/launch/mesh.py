"""Device meshes (``repro.launch.mesh`` for the port).

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis is the BHFL edge-server axis, the
slow, straggler-prone link between pods that HieAvg's hierarchy
amortizes.  Each mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the process group, so a mesh needs one: the dry-run
(``launch.dryrun``) starts a fake group of 512 ranks; a sweep over ranks
starts a real one (``gloo``, or ``nccl`` beside a ``gloo`` group for the
sweep's gather); the LLM steps on a mesh run on ``start_group``'s: NCCL
with a card a rank (``"nccl"``, a ``gloo`` group beside it for host
objects), or ``gloo`` carrying every collective through host memory
(``"staged"``, ``StagedGroup``), so that several ranks can share a card
or run on the CPU.  ``start_group`` also reads the environment torch's
launcher sets (``python -m torch.distributed.run --nproc-per-node N``),
one node only.  Where no group is running, ``make_debug_mesh`` and
``make_sweep_mesh`` start a group of one rank in this process.

``mesh_shape`` reads ``{axis: extent}`` from a ``DeviceMesh`` or from any
object whose ``.shape`` is such a mapping, so the sharding rules and the
census can be worked out for a mesh no process group backs.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from collections import Counter
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


#: the backend ``start_group`` registers: every collective of a rank's
#: tensors carried by ``gloo`` on host copies (``StagedGroup``)
STAGED = "gloo_staged"


class StagedGroup(dist.ProcessGroup):
    """A process group whose collectives run on a ``gloo`` group of the same
    ranks, each CUDA tensor copied to the host before and back after (a CPU
    tensor goes as it is).

    Several ranks share one card in the mesh checks, which NCCL refuses;
    ``gloo`` takes CUDA tensors itself for most collectives, but the
    functional all-gather that a DTensor's ``Shard -> Replicate`` issues
    crashed on CUDA tensors (torch 2.11, NVIDIA H100 80GB HBM3).  Staging
    every collective through the host the same way keeps one path for all
    of them.  ``CARRIED`` counts each kind's calls and bytes (one rank's
    input)."""

    CARRIED: Counter = Counter()

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self) -> str:
        return STAGED

    @property
    def group_name(self) -> str:
        return dist.distributed_c10d._world.pg_names[self]

    @staticmethod
    def _host(ts):
        return [t.cpu() for t in ts]

    @staticmethod
    def _back(dst, src) -> None:
        for d, s in zip(dst, src):
            if d is not s:
                d.copy_(s)

    def _note(self, kind: str, ts) -> None:
        self.CARRIED[kind, "count"] += 1
        self.CARRIED[kind, "bytes"] += sum(t.numel() * t.element_size()
                                           for t in ts)

    def _done(self):
        fut = torch.futures.Future()
        fut.set_result(None)
        return torch._C._distributed_c10d._create_work_from_future(fut)

    def allreduce(self, tensors, opts=None):
        self._note("all-reduce", tensors)
        host = self._host(tensors)
        self._gloo.allreduce(host, opts or dist.AllreduceOptions()).wait()
        self._back(tensors, host)
        return self._done()

    def allreduce_coalesced(self, tensors, opts=None):
        for t in tensors:
            self.allreduce([t], opts)
        return self._done()

    def broadcast(self, tensors, opts=None):
        self._note("broadcast", tensors)
        host = self._host(tensors)
        self._gloo.broadcast(host, opts or dist.BroadcastOptions()).wait()
        self._back(tensors, host)
        return self._done()

    def allgather(self, outputs, inputs, opts=None):
        self._note("all-gather", inputs)
        hin = self._host(inputs)
        hout = [self._host(o) for o in outputs]
        self._gloo.allgather(hout, hin).wait()
        for o, h in zip(outputs, hout):
            self._back(o, h)
        return self._done()

    def _allgather_base(self, output, input, opts=None):
        self._note("all-gather", [input])
        hout = output.cpu()
        self._gloo._allgather_base(hout, input.cpu()).wait()
        self._back([output], [hout])
        return self._done()

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i)
        return self._done()

    def reduce_scatter(self, outputs, inputs, opts=None):
        self._note("reduce-scatter", [t for ts in inputs for t in ts])
        hout = self._host(outputs)
        hin = [self._host(ts) for ts in inputs]
        self._gloo.reduce_scatter(hout, hin, opts or
                                  dist.ReduceScatterOptions()).wait()
        self._back(outputs, hout)
        return self._done()

    def _reduce_scatter_base(self, output, input, opts=None):
        self._note("reduce-scatter", [input])
        hout = output.cpu()
        self._gloo._reduce_scatter_base(
            hout, input.cpu(), opts or dist.ReduceScatterOptions()).wait()
        self._back([output], [hout])
        return self._done()

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return self._done()

    def alltoall_base(self, output, input, out_splits, in_splits,
                      opts=None):
        self._note("all-to-all", [input])
        hout = output.cpu()
        self._gloo.alltoall_base(hout, input.cpu(), out_splits or [],
                                 in_splits or [],
                                 opts or dist.AllToAllOptions()).wait()
        self._back([output], [hout])
        return self._done()

    all_to_all_single = alltoall_base

    def scatter(self, outputs, inputs, opts=None):
        self._note("scatter", [t for ts in inputs for t in ts])
        hout = self._host(outputs)
        hin = [self._host(ts) for ts in inputs]
        self._gloo.scatter(hout, hin, opts or dist.ScatterOptions()).wait()
        self._back(outputs, hout)
        return self._done()

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return self._done()


def _staged(store, rank: int, size: int, timeout) -> StagedGroup:
    return StagedGroup(store, rank, size, timeout)


#: ``start_group``'s backends: ``"auto"`` chooses one of the other two
BACKENDS = ("auto", "nccl", "staged")


@dataclasses.dataclass(frozen=True)
class Group:
    """What ``start_group`` started: this process's rank of ``world``, its
    rank on this node (its card under NCCL), the backend (``"nccl"`` or
    ``"staged"``) and why it was chosen, and the ``gloo`` group for host
    objects beside NCCL (None under ``"staged"``, whose group carries
    host tensors itself)."""

    rank: int
    world: int
    local_rank: int
    backend: str
    reason: str
    host: object = None


def choose_backend(backend: str, world: int) -> tuple[str, str]:
    """(backend, why) of ``start_group(backend=...)`` for ``world`` ranks on
    this node: ``"auto"`` is ``"nccl"`` where the node has a card a rank,
    ``"staged"`` otherwise; an explicit ``"nccl"`` that the node cannot
    honour raises (no CUDA, or fewer cards than ranks)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    have = f"{cards} card{'s' if cards != 1 else ''} for {world} " \
        f"rank{'s' if world != 1 else ''}"
    if backend == "staged":
        return "staged", f"asked for ({have})"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA, and no GPU is "
                               "present")
        if cards < world:
            raise RuntimeError(f"backend 'nccl' needs a card a rank: {have}"
                               "; NCCL refuses two ranks on one card (use "
                               "'staged')")
        return "nccl", f"asked for ({have})"
    if cards >= world:
        return "nccl", f"auto: {have}"
    return "staged", f"auto: {have}"


def _launcher_env(rank, world, port):
    """(rank, world, local rank, init method) from the arguments, or from
    torch's launcher's environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) where they are None;
    one node only."""
    env = os.environ
    if rank is None:
        if "RANK" not in env:
            raise RuntimeError("start_group needs rank, world and port, or "
                               "the environment of torch.distributed.run")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        if int(env.get("LOCAL_WORLD_SIZE", world)) != world:
            raise RuntimeError(
                f"{env['LOCAL_WORLD_SIZE']} of {world} ranks on this node: "
                "start_group supports a single node")
    else:
        local = rank
    if port is not None:
        return rank, world, local, f"tcp://127.0.0.1:{port}"
    if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
        raise RuntimeError("start_group needs a port, or MASTER_ADDR and "
                           "MASTER_PORT")
    return rank, world, local, "env://"


def start_group(rank: int | None = None, world: int | None = None,
                port: int | None = None, *, backend: str = "auto",
                timeout_s: float = 300.0) -> Group:
    """This process's rank of a ``world``-rank group on
    ``tcp://127.0.0.1:port`` (None: the environment of
    ``torch.distributed.run``, one node).  ``backend`` (``choose_backend``):
    ``"nccl"``, each rank on ``cuda:{local rank}``, set as this process's
    device before the group starts, with a ``gloo`` group beside it for
    host objects; ``"staged"``, every collective carried by ``gloo`` on
    host copies (``StagedGroup``): ranks that share a card, or the CPU;
    ``"auto"``, the first where the node has a card a rank.  A backend the
    node cannot honour raises before any group starts."""
    rank, world, local, method = _launcher_env(rank, world, port)
    chosen, reason = choose_backend(backend, world)
    timeout = datetime.timedelta(seconds=timeout_s)
    if chosen == "nccl":
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=method, rank=rank,
                                world_size=world, timeout=timeout,
                                device_id=torch.device("cuda", local))
        host = dist.new_group(backend="gloo", timeout=timeout)
        return Group(rank, world, local, chosen, reason, host)
    if STAGED not in dist.Backend.backend_list:
        dist.Backend.register_backend(STAGED, _staged,
                                      devices=["cpu", "cuda"])
    dist.init_process_group(STAGED, init_method=method, rank=rank,
                            world_size=world, timeout=timeout)
    return Group(rank, world, local, chosen, reason)


def group_backend() -> str:
    """The running group's backend by ``start_group``'s names: ``"nccl"``,
    ``"staged"``, or torch's own name for any other group."""
    name = dist.get_backend()
    return "staged" if name == STAGED else name


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
    """A ``DeviceMesh`` over the group's first ranks.  Under NCCL rank r
    computes on ``cuda:{local rank}``, the device ``start_group`` set
    (``DeviceMesh`` keeps a device already set)."""
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
