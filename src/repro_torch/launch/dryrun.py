"""Multi-pod dry-run: the inputs of every (arch x shape x mesh) pair, placed
on 512 ranks without a card (``repro.launch.dryrun`` for the port).

A fake process group of 512 ranks stands in for 2 pods x 256 cards, and
``launch.inputs.input_specs`` places every input of a pair on the
production mesh as a meta-device DTensor.  Per pair the record holds:

* ``bytes_per_device``: one rank's bytes of the step's arguments (the
  census of ``input_specs``), in all and split into ``params``,
  ``histories``, ``caches`` and ``batch`` (tokens, memory, masks, lr);
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` of the plain
  step (``kernel_mode="torch"``) at the pair's global shape on the meta
  device, counted once per arch x shape (it counts matmuls, attention
  and convolutions, which the mesh does not change);
* ``n_micro`` (train shapes), by the reference's rule.

* ``collectives``: ``{kind: {"count", "bytes"}}`` under the reference's
  five kinds (``KINDS``) and ``total_bytes``, of one rank running the
  plain step (``kernel_mode="torch"``) on the stand-ins over the fake
  group (``collective_census``): the DTensor redistributions of the
  ``model`` (and FSDP ``data``) axes and the FL axes' explicit
  all-reduces, as ``CommDebugMode`` counts them, and each call's output
  bytes on the rank (the reference counts each HLO collective's result
  bytes).  The step runs eagerly, so a loop's collectives are counted as
  often as they run: no trip-count parser is needed.  The counts are the
  port's own partitioning, not XLA's.

The reference's ``memory.temp_size_in_bytes`` and ``hlo_bytes`` read a
compiled program; the port compiles none, so they are ``null``.

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

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.hieavg import History
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
    """Tensors of the stand-ins' global shapes on ``device``: zeros (meta
    on the meta device), integer inputs as int64, as the drivers hand the
    steps their tokens."""
    if isinstance(tree, torch.Tensor):
        dtype = torch.long if tree.dtype == torch.int32 else tree.dtype
        return torch.zeros(tuple(tree.shape), dtype=dtype, device=device)
    if isinstance(tree, dict):
        return {k: materialize(v, device) for k, v in tree.items()}
    return dataclasses.replace(tree, **{
        f.name: materialize(getattr(tree, f.name), device)
        for f in dataclasses.fields(tree)})


def step_flops(cfg: ArchConfig, shape: InputShape, mesh, device="meta",
               micro: int = 1) -> float:
    """FLOPs of one plain step at the pair's global shape, as
    ``FlopCounterMode`` counts them, run on ``device``."""
    x = materialize(input_specs(cfg, shape, mesh), device)
    with FlopCounterMode(display=False) as fc:
        run_step(cfg, shape, None, x, micro=micro)
    return float(fc.get_total_flops())


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


def census_mode():
    """A ``CommDebugMode`` that also sums each collective's output bytes by
    kind (``.bytes``)."""
    from collections import Counter

    from torch.distributed.tensor.debug import CommDebugMode

    class Census(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            name = getattr(getattr(func, "_overloadpacket", None),
                           "__name__", "")
            if out is not NotImplemented and name in KIND_OF:
                self.bytes[KIND_OF[name]] += _out_bytes(name, args, out)
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


def collective_census(cfg: ArchConfig, shape: InputShape, mesh,
                      micro: int = 1) -> dict:
    """``by_kind`` of one rank's plain step on the pair's stand-ins over
    ``mesh`` (a ``DeviceMesh``, of a fake group in the dry-run)."""
    specs = input_specs(cfg, shape, mesh)
    with census_mode() as mode:
        run_step(cfg, shape, mesh, specs, micro=micro)
    return by_kind(mode)


def split_census(specs: dict, mesh) -> dict:
    """One rank's argument bytes by kind."""
    hist = [v for v in specs.values() if isinstance(v, History)]
    out = {"params": census(specs["params"], mesh),
           "histories": census(hist, mesh),
           "caches": census(specs.get("caches", {}), mesh)}
    out["batch"] = census(specs, mesh) - sum(out.values())
    return out


def run_pair(arch: str, shape_name: str, multi_pod: bool,
             flops_cache: dict) -> dict:
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
    if (arch, shape_name) not in flops_cache:
        t0 = time.time()
        flops_cache[arch, shape_name] = step_flops(cfg, shape, mesh,
                                                   micro=micro)
        rec["flops_s"] = round(time.time() - t0, 2)
    rec["flops"] = flops_cache[arch, shape_name]
    rec["bytes_per_device"] = sum(split.values())
    rec["memory"] = {"argument_size_in_bytes": rec["bytes_per_device"],
                     **{f"{k}_bytes": v for k, v in split.items()},
                     "temp_size_in_bytes": None}
    rec["hlo_bytes"] = None
    t0 = time.time()
    rec["collectives"] = collective_census(cfg, shape, mesh, micro=micro)
    rec["collectives_s"] = round(time.time() - t0, 2)
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
    results, failures, flops_cache = [], 0, {}
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
            rec = run_pair(a, s, mp, flops_cache)
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
