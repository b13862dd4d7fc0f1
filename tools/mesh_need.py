#!/usr/bin/env python3
"""How many cards a training configuration needs: one rank's dry-run bytes
on fake groups of 1, 2, 4 and 8 ranks over ``model``, and twice as many
with the reference's two edges over ``pod``, on the CPU.

    python3 tools/mesh_need.py [--out FILE] [--jobs N]

Each architecture trains at its full depth and width at ``chip_smoke.py``'s
train-line shape (TRAIN_KW: two rows of 8192 tokens for each of two
clients an edge; ``clients_per_pod`` = 2), its step placed on a (data=1,
model=N) mesh with TRAIN_KW's one edge, and on a (pod=2, data=1, model=N)
mesh with the reference's default of two edges, one a pod.  One process
per (arch, layout, N) (a process group is global to its process) starts
a fake group and runs ``launch.dryrun``'s ``step_census`` over the plain
step on the meta stand-ins: the rank's argument (the census), output and
temp bytes, ``bytes_per_device`` = argument + temp, and its FLOPs; beside
them the rank's setup peak in ``train.run(mesh=...)``
(``train.mesh_state``: its placed parameters and histories, the census's,
plus the largest whole leaf as it is drawn, in float32).  Prints one JSON
line per (arch, layout, N) with whether both fit an H100's 80 GB
(CARD_BYTES), and per (arch, layout) the least ``--mesh`` that fits;
writes them to FILE with ``--out``.  ``--jobs`` runs that many processes
at once.  Touches no card.  Imports only ``repro_torch`` (and
``chip_smoke.py``'s train-line shape).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama-3.2-vision-11b", "grok-1-314b", "recurrentgemma-9b")
MODELS = (1, 2, 4, 8)
#: the layouts: (pod extent, edges); pod 1 is no pod axis
LAYOUTS = ((1, 1), (2, 2))
CARD_BYTES = 80e9


def one(arch: str, model: int, pod: int) -> dict:
    """One rank's figures for ``arch`` on a (pod=``pod``, data=1,
    model=``model``) mesh (no pod axis at 1), one edge a pod, in this
    process (which starts the fake group)."""
    import dataclasses

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import TRAIN_KW
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, inputs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import param_specs
    from repro_torch.models.config import InputShape
    from repro_torch.models.spec import iter_specs
    torch.set_num_threads(1)
    dryrun.start_fake_group(pod * model)
    mesh = make_debug_mesh(data=1, model=model, pod=pod)
    e, c = pod, TRAIN_KW["n_clients"]
    cfg = dataclasses.replace(get_config(arch), clients_per_pod=c)
    shape = InputShape("train_line", TRAIN_KW["seq"],
                       e * c * TRAIN_KW["batch"], "train")
    assert inputs.fl_dims(cfg, shape, mesh) == (e, c, TRAIN_KW["batch"])
    specs = inputs.input_specs(cfg, shape, mesh)
    split = dryrun.split_census(specs, mesh)
    leaf = max(math.prod(sp.shape) for _, sp in
               iter_specs(param_specs(cfg))) * 4
    t0 = time.time()
    rec = dryrun.step_census(cfg, shape, mesh, specs)
    argument = sum(split.values())
    return {"arch": arch, "pod": pod, "model": model, "ranks": pod * model,
            "edges": e, "layers": cfg.n_layers, "argument": argument,
            **{f"{k}_bytes": v for k, v in split.items()},
            "largest_leaf_f32": leaf,
            "setup_peak": split["params"] + split["histories"] + leaf,
            "output": rec["output"], "temp": rec["temp"],
            "bytes_per_device": argument + rec["temp"],
            "flops": rec["flops"], "seconds": time.time() - t0}


def mesh_arg(pod: int, model: int) -> str:
    """``train --mesh``'s form of a layout."""
    return (f"pod={pod}," if pod > 1 else "") + f"data=1,model={model}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--one", nargs=3, metavar=("ARCH", "MODEL", "POD"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one[0], int(args.one[1]),
                             int(args.one[2]))))
        return 0
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def run(key):
        arch, (pod, _), n = key
        p = subprocess.run([sys.executable, __file__, "--one", arch, str(n),
                            str(pod)], capture_output=True, text=True,
                           env=env)
        if p.returncode != 0:
            return {"arch": arch, "pod": pod, "model": n,
                    "error": (p.stdout + p.stderr)[-2000:]}
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        rec["fits"] = max(rec["bytes_per_device"],
                          rec["setup_peak"]) <= CARD_BYTES
        return rec

    keys = [(a, lay, n) for a in ARCHS for lay in LAYOUTS for n in MODELS]
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        recs = dict(zip(keys, pool.map(run, keys)))
    lines = []
    for arch in ARCHS:
        for lay in LAYOUTS:
            fits = None
            for n in MODELS:
                rec = recs[arch, lay, n]
                print(json.dumps(rec), flush=True)
                lines.append(rec)
                if rec.get("fits") and fits is None:
                    fits = n
            summary = {"arch": arch, "pod": lay[0], "edges": lay[1],
                       "least_mesh_that_fits": None if fits is None
                       else mesh_arg(lay[0], fits),
                       "card_bytes": CARD_BYTES}
            print(json.dumps(summary), flush=True)
            lines.append(summary)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
