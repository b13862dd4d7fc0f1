#!/usr/bin/env python3
"""The conv kernels of two trees of the port, side by side on one GPU.

    python3 tools/ab_conv.py --parent DIR [--change DIR]

``DIR`` is the root of a checkout (``--change`` defaults to the one that
holds this script).  One process per tree, in turns (parent, change,
change, parent), each importing that tree's ``repro_torch`` and building
its kernels, measures at the paper's DEFAULT train shapes (D 25, B 32,
28 x 28; layer 2 32 -> 64 channels, layer 1 1 -> 32) and at the second
layer of each CNN geometry past the old limits (S1: 96 x 96, 32 -> 64;
S2: 28 x 28, 128 -> 256; S3: 2 x 2 devices, batch 8, 256 x 256, 8 -> 16):

  * ``conv3x3_fwd`` and ``conv3x3_bwd`` (with dx, except at layer 1, as
    the model asks): the wall time per call (CUDA events, the median of 5
    timings), and the device time per call of each kernel instance it
    launches (``torch.profiler``, by name);
  * a digest of every shape's outputs, and the rows of the DEFAULT HieAvg
    run cut to T = 4 with the kernels;
  * with ``--geometry``, the wall seconds of ``GEOMETRY_RUNS`` runs of each
    of ``chip_smoke.py``'s CNN geometries (its ``geometry`` phase's
    setting: HieAvg, T = 2, 5 steps an edge round) with the kernels.

Prints one JSON line per process, then a summary: each time per tree, the
instances, and per shape whether the outputs are bitwise the same in all
four processes and in the processes of each tree; whether the rows are;
and whether the DEFAULT shapes' instances (``DEFAULT_INSTANCES``) have the
same SASS in both trees' libraries (``cuobjdump -sass``).  With
``--sass-only``, builds both libraries and prints that comparison alone.
Needs one CUDA device; exits 2 without one.  Imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: (D, B, H, W, Cin, Cout, dx): the DEFAULT train shapes of both layers,
#: and the geometries' second layers (chip_smoke.py's GEOMETRY)
SHAPES = {"layer2": (25, 32, 28, 28, 32, 64, True),
          "layer1": (25, 32, 28, 28, 1, 32, False),
          "s1": (25, 32, 96, 96, 32, 64, True),
          "s2": (25, 32, 28, 28, 128, 256, True),
          "s3": (4, 8, 256, 256, 8, 16, True)}
ROWS = ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy")
#: the instances the DEFAULT shapes launch, by their mangled names' stems
DEFAULT_INSTANCES = ("conv3x3_fwd_kernelILi8ELi1E",
                     "conv3x3_fwd_kernelILi1ELi2E",
                     "conv3x3_dx_kernelILi8ELi2E", "conv3x3_dw_kernelILi8E",
                     "conv3x3_dw_kernelILi1E")


def sass(library: Path) -> dict:
    """Each conv kernel's SASS in ``library``, by the stem of its mangled
    name: its lines without the instruction offsets and with their runs of
    blanks as one (the listing pads its columns to the library's size)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = block.split("\n", 1)
        m = re.search(r"(conv3x3_[a-z_]+_kernel)(I(?:Li\d+E)+)", name)
        if m:
            out[m.group(1) + m.group(2)] = "\n".join(
                " ".join(re.sub(r"/\*[0-9a-f]+\*/", "", line).split())
                for line in body.splitlines())
    return out


def sass_equal(trees: dict) -> dict:
    """Whether each of DEFAULT_INSTANCES has the same SASS in both trees'
    built libraries (each tree's ``build/``, after its processes ran)."""
    code = {side: sass(sorted((tree / "build").glob(
        "libbhfl_kernels-*.so"))[-1]) for side, tree in trees.items()}
    return {k: k in code["change"] and code["parent"].get(k)
            == code["change"][k] for k in DEFAULT_INSTANCES}


def build_tree(tree: Path) -> int:
    """Build ``tree``'s kernel library (its own ``build.library()``)."""
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    return subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                           "import build; build.compile_library()"],
                          env=env, cwd=tree).returncode


def instances(torch, fn, calls: int = 5) -> dict:
    """The conv kernel instances ``fn()`` launches, by profiler name, and
    each one's device ms per call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.key_averages():
        m = re.search(r"(conv3x3_\w+_kernel<[^>]*>)", ev.key)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + \
                ev.self_device_time_total / 1e3 / calls
    return dict(sorted(out.items()))


#: runs of each geometry a process with ``--geometry``
GEOMETRY_RUNS = 3


def one(geometry: bool = False) -> dict:
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
    out["outputs_sha256"] = {}
    for label, (d, b, h, w, ci, co, dx) in SHAPES.items():
        digest = hashlib.sha256()
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
        out["outputs_sha256"][label] = digest.hexdigest()
        iters = 20 if d * b * h * w * ci * co < 1e10 else 5
        for name, fn in calls.items():
            out[f"{label}_{name}"] = {
                "ms": float(np.median([timed_ms(torch, fn, iters=iters)
                                       for _ in range(5)])),
                "device_ms": device_ms(torch, fn, ("conv3x3_",)),
                "instances": instances(torch, fn)}
        del x, wt, bias, dy, y, calls
        torch.cuda.empty_cache()
    res = BHFLSimulator(dataclasses.replace(DEFAULT, t_global_rounds=4),
                        "hieavg", "temporary", "temporary", device="cuda",
                        kernel_mode="auto").run()
    torch.cuda.synchronize()
    out["hieavg_t4"] = {r: [float(v) for v in getattr(res, r)] for r in ROWS}
    if geometry:
        from chip_smoke import GEOMETRY, GEOMETRY_KW, GEOMETRY_T
        for label, fields in GEOMETRY.items():
            setting = dataclasses.replace(DEFAULT, t_global_rounds=GEOMETRY_T,
                                          **fields)
            walls = []
            for _ in range(GEOMETRY_RUNS):
                res = BHFLSimulator(setting, "hieavg", "temporary",
                                    "temporary", device="cuda",
                                    kernel_mode="auto", **GEOMETRY_KW).run()
                torch.cuda.synchronize()
                walls.append(res.wall_time)
            out[f"geometry_{label}"] = walls
    return out


def trees_of(args: list) -> dict:
    """The parent and change checkouts named by ``--parent`` and
    ``--change`` (default: the one that holds this script)."""
    return {"parent": Path(args[args.index("--parent") + 1]).resolve(),
            "change": (Path(args[args.index("--change") + 1]).resolve()
                       if "--change" in args else ROOT)}


def in_turns(script: Path, trees: dict, args: tuple = ()):
    """``script --one [args]`` in one process a tree, in turns (parent,
    change, change, parent), each on its tree's ``repro_torch``: the last
    JSON line of each, with its side, printed as it comes; or the exit code
    of the first process that failed."""
    lines = []
    for side in ("parent", "change", "change", "parent"):
        env = dict(os.environ, PYTHONPATH=str(trees[side] / "src"))
        proc = subprocess.run([sys.executable, str(script), "--one", *args],
                              env=env, cwd=trees[side], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        line["side"] = side
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main() -> int:
    if "--one" in sys.argv[1:]:
        import torch
        if not torch.cuda.is_available():
            print("ab_conv: no CUDA device is available", file=sys.stderr)
            return 2
        print(json.dumps(one("--geometry" in sys.argv[1:])), flush=True)
        return 0
    trees = trees_of(sys.argv[1:])
    if "--sass-only" in sys.argv[1:]:
        for tree in trees.values():
            if build_tree(tree):
                return 1
        print(json.dumps({"default_sass_equal": sass_equal(trees)}))
        return 0
    geometry = "--geometry" in sys.argv[1:]
    lines = in_turns(Path(__file__).resolve(), trees,
                     ("--geometry",) if geometry else ())
    if isinstance(lines, int):
        return lines
    summary: dict = {"order": [x["side"] for x in lines]}
    for key in (f"{s}_{n}" for s in SHAPES for n in ("fwd", "bwd")):
        summary[key] = {side: {k: [x[key][k] for x in lines
                                   if x["side"] == side]
                               for k in ("ms", "device_ms")}
                        for side in ("parent", "change")}
        summary[key]["instances"] = {
            side: [x[key]["instances"] for x in lines if x["side"] == side]
            for side in ("parent", "change")}
        summary[key]["instances_equal"] = all(
            list(x[key]["instances"]) == list(lines[0][key]["instances"])
            for x in lines)
    summary["outputs_bitwise"] = {
        label: {"all": all(x["outputs_sha256"][label]
                           == lines[0]["outputs_sha256"][label]
                           for x in lines),
                **{side: len({x["outputs_sha256"][label] for x in lines
                              if x["side"] == side}) == 1
                   for side in ("parent", "change")}}
        for label in SHAPES}
    summary["rows_bitwise"] = all(x["hieavg_t4"] == lines[0]["hieavg_t4"]
                                  for x in lines)
    summary["default_sass_equal"] = sass_equal(trees)
    for key in (k for k in lines[0] if k.startswith("geometry_")):
        summary[key] = {side: [x[key] for x in lines if x["side"] == side]
                        for side in ("parent", "change")}
    print(json.dumps({"ab_conv": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
