#!/usr/bin/env python3
"""The coefficient aggregates of two trees of the port, side by side on one
GPU.

    python3 tools/ab_coef_agg.py --parent DIR [--change DIR]

``DIR`` is the root of a checkout (``--change`` defaults to the one that
holds this script).  One process per tree, in turns (parent, change,
change, parent: ``ab_conv.in_turns``), each importing that tree's
``repro_torch`` and building its kernels, measures what both trees share:

  * ``ops.fused_coef_aggregate`` and ``ops.fused_coef_aggregate_pair``
    over the paper's CNN's six leaves at DEFAULT width, B = n = 5, and
    ``hieavg_agg_many`` over the same leaves with float32 history
    (PERF.md's row 4: a host-bound wrapper): the wall time per call (CUDA
    events, the median of 5 timings of 20 calls), the device time of the
    kernels per call (``torch.profiler``), the host time per call (the
    median of 5) and the launches per call;
  * the smoke runs (DEFAULT cut to T = 4) of FedAvg, delayed-gradient and
    HieAvg aggregation with the kernels: their rows;
  * the whole DEFAULT runs (T = 50) of FedAvg and delayed-gradient
    aggregation with the kernels: wall seconds and final accuracy.

Prints one JSON line per process, then a summary: each metric per tree and
whether every smoke run's rows are bitwise the same in all four processes.
Needs one CUDA device; exits 2 without one.  Imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ab_conv import ROOT, in_turns, trees_of  # noqa: E402

#: the smoke runs whose rows are compared: label -> (aggregator, stragglers)
RUNS = {"fedavg": ("fedavg", "none"),
        "delayed_grad": ("delayed_grad", "temporary"),
        "hieavg": ("hieavg", "temporary")}
ROWS = ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy")


def one() -> dict:
    """The measurements of the tree on ``PYTHONPATH``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, host_ms, timed_ms
    from repro_torch.configs import DEFAULT
    from repro_torch.fl import BHFLSimulator
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.hieavg_agg import hieavg_agg_many
    from repro_torch.models import cnn_specs

    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    nb, n = 5, 5
    shapes = [tuple(s.shape) for s in cnn_specs(28, 1, 10, c1=32,
                                                   c2=64).values()]
    ws = {f"l{k}": torch.randn((nb, n) + s, generator=gen, device=dev)
          for k, s in enumerate(shapes)}
    aux = {k: torch.randn(w.shape, generator=gen, device=dev)
           for k, w in ws.items()}
    c = torch.rand((nb, n), generator=gen, device=dev)
    m = torch.rand((nb, n), generator=gen, device=dev) > 0.4
    ca, cb = c * m, c * ~m
    leaves, hist = list(ws.values()), list(aux.values())
    calls = {"coef_agg": lambda: ops.fused_coef_aggregate(ws, c),
             "coef_agg_pair": lambda: ops.fused_coef_aggregate_pair(
                 ws, aux, ca, cb),
             "hieavg_agg": lambda: hieavg_agg_many(
                 leaves, hist, hist, m.float(), ca, cb, c, mode="cuda")}
    out: dict = {"tree": os.environ.get("PYTHONPATH", ""),
                 "device": torch.cuda.get_device_name(0)}
    for name, fn in calls.items():
        before = sum(build.LAUNCHES.values())
        fn()
        launches = sum(build.LAUNCHES.values()) - before
        out[name] = {
            "ms": float(np.median([timed_ms(torch, fn) for _ in range(5)])),
            "device_ms": device_ms(torch, fn, (name.replace("_pair", "")
                                               + "_kernel",)),
            "host_ms": float(np.median([host_ms(torch, fn)
                                        for _ in range(5)])),
            "launches_per_call": launches}
    setting = dataclasses.replace(DEFAULT, t_global_rounds=4)
    for label, (agg, strag) in RUNS.items():
        res = BHFLSimulator(setting, agg, strag, strag, device="cuda",
                            kernel_mode="auto").run()
        torch.cuda.synchronize()
        out[label] = {r: [float(v) for v in getattr(res, r)] for r in ROWS}
    for label in ("fedavg", "delayed_grad"):
        agg, strag = RUNS[label]
        res = BHFLSimulator(DEFAULT, agg, strag, strag, device="cuda",
                            kernel_mode="auto").run()
        torch.cuda.synchronize()
        out[f"{label}_t{DEFAULT.t_global_rounds}"] = {
            "wall_s": res.wall_time,
            "final_accuracy": float(res.accuracy[-1])}
    return out


def main() -> int:
    if "--one" in sys.argv[1:]:
        import torch
        if not torch.cuda.is_available():
            print("ab_coef_agg: no CUDA device is available", file=sys.stderr)
            return 2
        print(json.dumps(one()), flush=True)
        return 0
    lines = in_turns(Path(__file__).resolve(), trees_of(sys.argv[1:]))
    if isinstance(lines, int):
        return lines
    summary: dict = {"order": [x["side"] for x in lines]}
    for name in ("coef_agg", "coef_agg_pair", "hieavg_agg"):
        summary[name] = {side: {k: [x[name][k] for x in lines
                                    if x["side"] == side]
                                for k in lines[0][name]}
                         for side in ("parent", "change")}
    for label in ("fedavg", "delayed_grad"):
        key = next(k for k in lines[0] if k.startswith(f"{label}_t"))
        summary[key] = {side: [x[key] for x in lines if x["side"] == side]
                        for side in ("parent", "change")}
    summary["rows_bitwise"] = {
        label: all(x[label] == lines[0][label] for x in lines)
        for label in RUNS}
    print(json.dumps({"ab_coef_agg": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
