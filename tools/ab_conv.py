#!/usr/bin/env python3
"""The conv kernels of two trees of the port, side by side on one GPU.

    python3 tools/ab_conv.py --parent DIR [--change DIR]

``DIR`` is the root of a checkout (``--change`` defaults to the one that
holds this script).  One process per tree, in turns (parent, change,
change, parent), each importing that tree's ``repro_torch`` and building
its kernels, measures at the paper's DEFAULT train shapes (D 25, B 32,
28 x 28; layer 2 32 -> 64 channels, layer 1 1 -> 32):

  * ``conv3x3_fwd`` and ``conv3x3_bwd`` (with dx at layer 2, without at
    layer 1, as the model asks): the wall time per call (CUDA events, the
    median of 5 timings of 20 calls), the device time of the kernels per
    call (``torch.profiler``) and the kernel instances each launches (their
    names from the profiler);
  * a digest of every output, and the rows of the DEFAULT HieAvg run cut
    to T = 4 with the kernels.

Prints one JSON line per process, then a summary: each time per tree, the
instances, and whether the outputs and rows are bitwise the same in all
four processes.  Needs one CUDA device; exits 2 without one.  Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: (D, B, H, W, Cin, Cout, dx): the DEFAULT train shapes of both layers
SHAPES = {"layer2": (25, 32, 28, 28, 32, 64, True),
          "layer1": (25, 32, 28, 28, 1, 32, False)}
ROWS = ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy")


def instances(torch, fn) -> list:
    """The conv kernel instances ``fn()`` launches, by profiler name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return sorted({m.group(1) for ev in prof.key_averages()
                   for m in [re.search(r"(conv3x3_\w+_kernel<[^>]*>)",
                                       ev.key)] if m})


def one() -> dict:
    """The measurements of the tree on ``PYTHONPATH``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, timed_ms
    from repro_torch.configs import DEFAULT
    from repro_torch.fl import BHFLSimulator
    from repro_torch.kernels import build
    from repro_torch.kernels.conv3x3 import conv3x3_bwd, conv3x3_fwd

    build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out: dict = {"tree": os.environ.get("PYTHONPATH", ""),
                 "device": torch.cuda.get_device_name(0)}
    digest = hashlib.sha256()
    for label, (d, b, h, w, ci, co, dx) in SHAPES.items():
        x = torch.rand((d, b, h, w, ci), generator=gen, device=dev)
        wt = torch.randn((d, 3, 3, ci, co), generator=gen,
                         device=dev) * (9 * ci) ** -0.5
        bias = torch.randn((d, co), generator=gen, device=dev) * 0.1
        dy = torch.randn((d, b, h, w, co), generator=gen, device=dev)
        y = conv3x3_fwd(x, wt, bias, "cuda")
        calls = {"fwd": lambda: conv3x3_fwd(x, wt, bias, "cuda"),
                 "bwd": lambda: conv3x3_bwd(x, wt, y, dy, dx, "cuda")}
        for t in (y, *calls["bwd"]()):
            if t is not None:
                digest.update(t.cpu().numpy().tobytes())
        for name, fn in calls.items():
            out[f"{label}_{name}"] = {
                "ms": float(np.median([timed_ms(torch, fn)
                                       for _ in range(5)])),
                "device_ms": device_ms(torch, fn, ("conv3x3_",)),
                "instances": instances(torch, fn)}
    out["outputs_sha256"] = digest.hexdigest()
    res = BHFLSimulator(dataclasses.replace(DEFAULT, t_global_rounds=4),
                        "hieavg", "temporary", "temporary", device="cuda",
                        kernel_mode="auto").run()
    torch.cuda.synchronize()
    out["hieavg_t4"] = {r: [float(v) for v in getattr(res, r)] for r in ROWS}
    return out


def main() -> int:
    if "--one" in sys.argv[1:]:
        import torch
        if not torch.cuda.is_available():
            print("ab_conv: no CUDA device is available", file=sys.stderr)
            return 2
        print(json.dumps(one()), flush=True)
        return 0
    args = sys.argv[1:]
    trees = {"parent": Path(args[args.index("--parent") + 1]).resolve(),
             "change": (Path(args[args.index("--change") + 1]).resolve()
                        if "--change" in args else ROOT)}
    lines = []
    for side in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(trees[side] / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--one"], env=env, cwd=trees[side],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["side"] = side
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary: dict = {"order": [x["side"] for x in lines]}
    for key in (f"{s}_{n}" for s in SHAPES for n in ("fwd", "bwd")):
        summary[key] = {side: {k: [x[key][k] for x in lines
                                   if x["side"] == side]
                               for k in ("ms", "device_ms")}
                        for side in ("parent", "change")}
        summary[key]["instances_equal"] = all(
            x[key]["instances"] == lines[0][key]["instances"] for x in lines)
        summary[key]["instances"] = lines[0][key]["instances"]
    summary["outputs_bitwise"] = all(
        x["outputs_sha256"] == lines[0]["outputs_sha256"] for x in lines)
    summary["rows_bitwise"] = all(x["hieavg_t4"] == lines[0]["hieavg_t4"]
                                  for x in lines)
    print(json.dumps({"ab_conv": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
