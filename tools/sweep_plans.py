#!/usr/bin/env python3
"""Fig. 3's grid under three bucket plans and one by one, on one GPU.

    python3 tools/sweep_plans.py [--t T] [--repeat R]

The grid is ``chip_smoke.py``'s Fig. 3 (eleven rows: J, N, K, straggler
fraction) at DEFAULT width, cut to ``T`` global rounds (default 4), one
epoch over each device's own shard.  Each of these runs ``R`` times
(default 3), in turns, with the kernels (``kernel_mode="auto"``):

  * ``proxy``: ``bucket_cost="proxy"``, at most 4 buckets: the
    reference's plan (the volume ``t·k·n·j·steps`` prices a point);
  * ``measured_cap4``: ``bucket_cost="measured"`` (a bucket priced by the
    measured seconds of its stacked steps), ``max_buckets=4``;
  * ``measured``: the same with no cap, the default: no merge is forced;
  * ``one_by_one``: every point as its own ``BHFLSimulator`` run.

A warm-up run of the measured plan goes first.  Prints the card's name and
power limit, then one JSON line: each plan's buckets and plan seconds, and
the wall seconds of every run.  Needs one CUDA device; exits 2 without
one.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sweep_plans: no CUDA device is available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    T = int(args[args.index("--t") + 1]) if "--t" in args else 4
    repeat = int(args[args.index("--repeat") + 1]) if "--repeat" in args \
        else 3
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import SWEEP_KW, _point_sim, fig3_overrides
    from repro_torch import fl
    from repro_torch.configs import DEFAULT
    from repro_torch.kernels import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    build.library()
    setting = dataclasses.replace(DEFAULT, t_global_rounds=T)
    overrides = fig3_overrides()
    knobs = {"proxy": dict(bucket_cost="proxy"),
             "measured_cap4": dict(bucket_cost="measured", max_buckets=4),
             "measured": dict(bucket_cost="measured")}
    plans, out = {}, {"t_global_rounds": T, **SWEEP_KW, "plans": {}}
    for name, kw in knobs.items():
        t0 = time.time()
        plans[name] = fl.plan_sweep(setting, overrides=overrides,
                                    device="cuda", kernel_mode="auto",
                                    **kw, **SWEEP_KW)
        out["plans"][name] = {"plan_s": time.time() - t0, **kw,
                              "buckets": plans[name].describe().splitlines()}
    fl.run_plan(plans["measured"], donate=False)          # warm-up

    def one_by_one():
        for ov, seed in plans["measured"].points:
            _point_sim(fl.BHFLSimulator, setting, ov, seed, "auto").run()

    runs = {**{name: (lambda p=p: fl.run_plan(p, donate=False))
               for name, p in plans.items()}, "one_by_one": one_by_one}
    wall = {name: [] for name in runs}
    for _ in range(repeat):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall[name].append(time.time() - t0)
    out["wall_s"] = wall
    out["points"] = len(overrides)
    print(json.dumps({"sweep_plans": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
