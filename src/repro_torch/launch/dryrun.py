"""Multi-pod dry-run: every (arch x shape x mesh) pair's step, one rank's
share of it, on 512 ranks without a card (``repro.launch.dryrun`` for the
port).

A fake process group of 512 ranks stands in for 2 pods x 256 cards, and
``launch.inputs.input_specs`` places every input of a pair on the
production mesh as a meta-device DTensor.  One run of the plain step
(``kernel_mode="torch"``; the reference's dry-run likewise counts its XLA
path, which has no Pallas kernel on the CPU) on those stand-ins over the
fake group, under one dispatch mode (``census_mode``, ``step_census``),
sees the rank's own local ops, and gives every figure of the record, each
one rank's, as XLA's analyses of the partitioned program give the
reference's:

* ``flops``: ``torch.utils.flop_counter``'s formulas over the rank's
  local ops (matmuls, attention, convolutions on its shards);
* ``memory``: ``argument_size_in_bytes`` (the census of ``input_specs``,
  also split into ``params``, ``histories``, ``caches`` and ``batch``:
  tokens, memory, masks, lr), ``output_size_in_bytes`` (the outputs'
  storages that alias no argument), ``temp_size_in_bytes`` (the peak of
  live bytes less argument and output, at least 0: the rank's live
  storages tracked op by op, a view or an in-place op adding nothing, a
  storage leaving when its last reference dies, so autograd's saved
  tensors and the remat recompute count for as long as they live; what an
  op allocates inside itself, such as a library's workspace, is not
  seen); ``generated_code_size_in_bytes`` is ``null``: no program is
  generated per pair;
* ``bytes_per_device``: argument + temp, the reference's formula;
* ``hlo_bytes``: bytes accessed, the local bytes of every non-view op's
  tensor inputs and outputs, summed.  Eager PyTorch fuses nothing, so
  this reads above XLA's figure by design;
* ``collectives``: ``{kind: {"count", "bytes"}}`` under the reference's
  five kinds (``KINDS``) and ``total_bytes``: the DTensor
  redistributions of the ``model`` (and FSDP ``data``) axes and the FL
  axes' explicit all-reduces, as ``CommDebugMode`` counts them, and each
  call's output bytes on the rank (the reference counts each HLO
  collective's result bytes).  The step runs eagerly, so a loop's
  collectives are counted as often as they run: no trip-count parser is
  needed.  The counts are the port's own partitioning, not XLA's;
* ``n_micro`` (train shapes), by the reference's rule; ``census_s`` and
  ``lower_s`` (the seconds of the census and of the one run).

``step_flops`` counts the whole step at the pair's global shape (no
mesh), by the same census: the figure a rank's count is held against.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k \\
      --mesh pod
  python -m repro_torch.launch.dryrun --all --out dryrun_results.json

A process group is global to its process: run this as its own process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.hieavg import History
from repro_torch.launch import inputs
from repro_torch.launch.inputs import census, fl_dims, input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (make_hfl_train_step, make_prefill_step,
                                      make_serve_step)
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, InputShape

N_RANKS = 512

#: the reference's collective kinds (``repro.launch.dryrun._COLLECTIVES``)
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
#: the kind of each collective op that ``CommDebugMode`` counts, by name
#: (functional collectives, and the c10d ops of explicit calls)
KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}


def start_fake_group(world: int = N_RANKS) -> None:
    """A process group of ``world`` ranks whose collectives do nothing, in
    this process (rank 0): enough to build the production meshes."""
    # the fake backend lives in torch's internal testing package
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "full quadratic attention — 512k decode infeasible " \
                      "by design (DESIGN.md §Arch-applicability)"
    return True, ""


def n_micro(cfg: ArchConfig, shape: InputShape, mesh) -> int:
    """Microbatches of a train step: an ~8-sequence activation working set
    a client (16 where one client a pod re-gathers its FSDP weights every
    microbatch)."""
    _, _, b_client = fl_dims(cfg, shape, mesh)
    target = 16 if cfg.clients_per_pod == 1 else 8
    return max(b_client // target, 1)


def materialize(tree, device):
    """Tensors of the global shapes of a tree's tensors (stand-ins, or
    real inputs) on ``device``: zeros (nothing allocated on the meta
    device), int32 inputs as int64, as the drivers hand the steps their
    tokens; anything else kept."""
    if isinstance(tree, torch.Tensor):
        dtype = torch.long if tree.dtype == torch.int32 else tree.dtype
        return torch.zeros(tuple(tree.shape), dtype=dtype, device=device)
    if isinstance(tree, dict):
        return {k: materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(materialize(v, device) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: materialize(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree


def step_flops(cfg: ArchConfig, shape: InputShape, mesh, device="meta",
               micro: int = 1) -> float:
    """FLOPs of one plain step at the pair's global shape (``mesh``'s
    stand-ins made whole), run on ``device``: ``step_census`` with no
    mesh."""
    x = materialize(input_specs(cfg, shape, mesh), device)
    return step_census(cfg, shape, None, x, micro=micro)["flops"]


def _out_bytes(name: str, args, out) -> int:
    """One rank's output bytes of a collective: a functional op's result,
    a c10d op's output buffers (its first argument)."""
    def size(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, (list, tuple)):
            return sum(size(y) for y in x)
        return 0
    return size(out) if not name.endswith("_") else size(args[0])


def tensors_of(x) -> list:
    """The tensors of nested tuples, lists, dicts and dataclasses (an op's
    arguments, a step's inputs and outputs), a DTensor as its local
    shard."""
    if isinstance(x, torch.Tensor):
        return [getattr(x, "_local_tensor", x)]
    if isinstance(x, (tuple, list)):
        return [t for y in x for t in tensors_of(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in tensors_of(y)]
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in tensors_of(getattr(x, f.name))]
    return []


def census_mode(frees: bool = True):
    """A dispatch mode that sees one rank's step as the rank's own local
    ops.  A ``CommDebugMode`` (collectives by op) that also sums each
    collective's output bytes by kind (``.bytes``) and, over every local
    op (a DTensor op is left to DTensor, whose local ops come back here;
    the ops that sharding propagation runs on fake tensors at the global
    shape are not the rank's and are not counted), keeps:

    * ``.flops``: ``torch.utils.flop_counter``'s formulas, as
      ``FlopCounterMode`` applies them (an op without one decomposed
      first where it can be);
    * ``.current``, ``.peak``: the rank's live bytes, counted by storage.
      A view or an in-place op adds nothing; a storage leaves when its
      last reference dies, so autograd's saved tensors and a remat
      recompute count for as long as they live.  ``hold`` registers the
      arguments.  With ``frees=False`` nothing leaves: the control that
      shows the frees matter;
    * ``.hlo_bytes``: the bytes each op that is not a view reads and
      writes (its tensor inputs and outputs), summed.
    """
    import threading
    from collections import Counter

    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import (TorchDispatchMode,
                                              _get_current_dispatch_mode_stack)
    from torch.utils.flop_counter import flop_registry

    def faked(types) -> bool:
        return any(issubclass(t, FakeTensor) for t in types) or any(
            isinstance(m, FakeTensorMode)
            for m in _get_current_dispatch_mode_stack())

    class Census(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = Counter()
            self.flops = self.hlo_bytes = self.current = self.peak = 0
            self._size: dict = {}     # storage -> bytes, while it lives
            self._refs: dict = {}     # storage -> its weak reference
            self._lock = threading.Lock()
            self._args: set = set()

        def hold(self, tree) -> int:
            """Count the storages of ``tree``'s tensors (a DTensor's local
            shard) as live, as the step's arguments; their bytes, each
            storage once."""
            self._args = {self._hold(t) for t in tensors_of(tree)}
            return sum(self._size[k] for k in self._args)

        def fresh(self, tree) -> int:
            """The bytes of ``tree``'s storages that no argument holds (a
            step's outputs that do not alias an argument)."""
            sts = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                   for t in tensors_of(tree)}
            return sum(n for k, n in sts.items() if k not in self._args)

        def _hold(self, t):
            st = t.untyped_storage()
            key = st._cdata
            with self._lock:
                if key not in self._size:
                    self._size[key] = st.nbytes()
                    self.current += st.nbytes()
                    self.peak = max(self.peak, self.current)
                    # called when the storage's last reference dies
                    self._refs[key] = weakref.ref(
                        st, lambda _, k=key: self._leave(k))
            return key

        def _leave(self, key) -> None:
            with self._lock:
                n = self._size.pop(key)
                del self._refs[key]
                if frees:
                    self.current -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if faked(types):
                return func(*args, **kwargs)
            if not isinstance(func, torch._ops.OpOverload):
                return super().__torch_dispatch__(func, types, args, kwargs)
            packet = func._overloadpacket
            if packet not in flop_registry and not any(
                    issubclass(t, DTensor) for t in types):
                TorchDispatchMode.__enter__(self)
                try:
                    out = func.decompose(*args, **kwargs)
                finally:
                    TorchDispatchMode.__exit__(self, None, None, None)
                if out is not NotImplemented:
                    return out
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented:
                return out
            if packet.__name__ in KIND_OF:
                self.bytes[KIND_OF[packet.__name__]] += _out_bytes(
                    packet.__name__, args, out)
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            outs = tensors_of(out)
            if outs and not func.is_view:
                ins = tensors_of((args, kwargs))
                self.hlo_bytes += sum(t.numel() * t.element_size()
                                      for t in ins + outs)
                seen = {t.untyped_storage()._cdata for t in ins}
                for t in outs:
                    if t.untyped_storage()._cdata not in seen:
                        self._hold(t)
            return out

    return Census()


def by_kind(mode) -> dict:
    """``{kind: {"count", "bytes"}}`` over ``KINDS`` (a kind outside them,
    such as a broadcast, under its op's name) and ``total_bytes``, of a
    ``census_mode`` (or a plain ``CommDebugMode``: bytes 0)."""
    out = {k: {"count": 0, "bytes": 0} for k in KINDS}
    for op, n in mode.get_comm_counts().items():
        name = getattr(op, "__name__", str(op))
        kind = KIND_OF.get(name, name)
        out.setdefault(kind, {"count": 0, "bytes": 0})["count"] += n
    for kind, b in getattr(mode, "bytes", {}).items():
        out[kind]["bytes"] += b
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def run_step(cfg: ArchConfig, shape: InputShape, mesh, x: dict, *,
             micro: int = 1, kernel_mode: str = "torch"):
    """The step of ``shape``'s kind on inputs ``x`` (``input_specs``'s
    tree: stand-ins, or tensors placed as they are) over ``mesh`` (None:
    whole tensors, no mesh)."""
    if shape.kind == "train":
        step = make_hfl_train_step(cfg, n_micro=micro, mesh=mesh,
                                   kernel_mode=kernel_mode)
        return step(x["params"], x["dev_hist"], x["glob_hist"], x["batch"],
                    x["dev_mask"], x["edge_mask"], x["lr"])
    if shape.kind == "prefill":
        return make_prefill_step(cfg, kernel_mode, mesh=mesh)(
            x["params"], x["tokens"], x["caches"], memory=x.get("memory"))
    return make_serve_step(cfg, mesh=mesh)(
        x["params"], x["token"], shape.seq_len - 1, x["caches"],
        x.get("memory"))


def track(run, x, *, frees: bool = True) -> dict:
    """``run(x)`` counted by one ``census_mode``: its ``collectives``
    (``by_kind``), ``flops`` and ``hlo_bytes``, and its bytes: ``argument``
    (``x``'s storages), ``output`` (the result's storages that alias no
    argument), ``peak`` (live bytes at the most, the arguments included)
    and ``temp`` (peak less argument and output, at least 0: XLA's buffer
    assignment adds the three up the same way)."""
    mode = census_mode(frees)
    with mode:
        argument = mode.hold(x)
        out = run(x)
    output = mode.fresh(out)
    return {"collectives": by_kind(mode), "flops": float(mode.flops),
            "hlo_bytes": float(mode.hlo_bytes), "argument": argument,
            "output": output, "peak": mode.peak,
            "temp": max(mode.peak - argument - output, 0)}


def step_census(cfg: ArchConfig, shape: InputShape, mesh, x=None, *,
                micro: int = 1, frees: bool = True) -> dict:
    """``track`` of one rank's plain step on ``x`` (by default the pair's
    stand-ins over ``mesh``, a ``DeviceMesh`` of a fake group in the
    dry-run; ``mesh`` None runs whole tensors)."""
    if x is None:
        x = input_specs(cfg, shape, mesh)
    return track(lambda x: run_step(cfg, shape, mesh, x, micro=micro), x,
                 frees=frees)


def collective_census(cfg: ArchConfig, shape: InputShape, mesh,
                      micro: int = 1) -> dict:
    """``by_kind`` of one rank's plain step on the pair's stand-ins over
    ``mesh`` (``step_census``)."""
    return step_census(cfg, shape, mesh, micro=micro)["collectives"]


def split_census(specs: dict, mesh) -> dict:
    """One rank's argument bytes by kind."""
    hist = [v for v in specs.values() if isinstance(v, History)]
    out = {"params": census(specs["params"], mesh),
           "histories": census(hist, mesh),
           "caches": census(specs.get("caches", {}), mesh)}
    out["batch"] = census(specs, mesh) - sum(out.values())
    return out


def run_pair(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    t0 = time.time()
    specs = input_specs(cfg, shape, mesh)
    split = split_census(specs, mesh)
    rec["census_s"] = round(time.time() - t0, 3)
    micro = 1
    if shape.kind == "train":
        micro = rec["n_micro"] = n_micro(cfg, shape, mesh)
    t0 = time.time()
    one = step_census(cfg, shape, mesh, specs, micro=micro)
    rec["lower_s"] = round(time.time() - t0, 2)
    argument = sum(split.values())
    rec["memory"] = {"argument_size_in_bytes": argument,
                     "output_size_in_bytes": one["output"],
                     "temp_size_in_bytes": one["temp"],
                     "generated_code_size_in_bytes": None,
                     **{f"{k}_bytes": v for k, v in split.items()}}
    rec["bytes_per_device"] = argument + one["temp"]
    rec["flops"] = one["flops"]
    rec["hlo_bytes"] = one["hlo_bytes"]
    rec["collectives"] = one["collectives"]
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    pairs = []
    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if (args.all or not args.shape) \
        else (args.shape,)
    meshes = {"pod": (False,), "multipod": (True,),
              "both": (False, True)}[args.mesh]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                pairs.append((a, s, mp))

    start_fake_group()
    results, failures = [], 0
    for a, s, mp in pairs:
        ok, why = applicable(a, s)
        label = f"{a} x {s} x {'2x16x16' if mp else '16x16'}"
        if not ok:
            print(f"SKIP {label}: {why}")
            results.append({"arch": a, "shape": s,
                            "mesh": "2x16x16" if mp else "16x16",
                            "skipped": why})
            continue
        try:
            rec = run_pair(a, s, mp)
            print(f"OK   {label}: flops={rec['flops']:.3e} "
                  f"mem/dev={rec['bytes_per_device'] / 2**30:.2f}GiB")
            results.append(rec)
        except Exception as e:  # a failure here is a placement bug
            failures += 1
            print(f"FAIL {label}: {e}")
            traceback.print_exc()
            results.append({"arch": a, "shape": s,
                            "mesh": "2x16x16" if mp else "16x16",
                            "error": str(e)})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    dist.destroy_process_group()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
