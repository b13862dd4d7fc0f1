#!/usr/bin/env python3
"""How many cards a training configuration needs: one rank's dry-run bytes
on fake groups of 1, 2, 4 and 8 ranks over ``model``, on the CPU.

    python3 tools/mesh_need.py [--out FILE]

Each architecture trains at its full depth and width at ``chip_smoke.py``'s
train-line shape (TRAIN_KW: one edge of two clients, two rows of 8192
tokens a client; ``clients_per_pod`` = 2), its step placed on a (data=1,
model=N) mesh of a fake process group.  One process per group size (a
process group is global to its process) runs ``launch.dryrun``'s
``step_census`` over the plain step on the meta stand-ins: the rank's
argument (the census), output and temp bytes, ``bytes_per_device`` =
argument + temp, and its FLOPs.  Prints one JSON line per (arch, N) with
whether ``bytes_per_device`` fits an H100's 80 GB (CARD_BYTES), and the
least N that fits; writes them to FILE with ``--out``.  Touches no card.
Imports only ``repro_torch`` (and ``chip_smoke.py``'s train-line shape).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama-3.2-vision-11b", "grok-1-314b", "recurrentgemma-9b")
MODELS = (1, 2, 4, 8)
CARD_BYTES = 80e9


def one(arch: str, model: int) -> dict:
    """One rank's figures for ``arch`` on a (data=1, model=``model``)
    mesh, in this process (which starts the fake group)."""
    import dataclasses

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import TRAIN_KW
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, inputs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.config import InputShape
    torch.set_num_threads(1)
    dryrun.start_fake_group(model)
    mesh = make_debug_mesh(data=1, model=model)
    e, c = TRAIN_KW["n_edges"], TRAIN_KW["n_clients"]
    cfg = dataclasses.replace(get_config(arch), clients_per_pod=c)
    shape = InputShape("train_line", TRAIN_KW["seq"],
                       e * c * TRAIN_KW["batch"], "train")
    assert inputs.fl_dims(cfg, shape, mesh) == (e, c, TRAIN_KW["batch"])
    specs = inputs.input_specs(cfg, shape, mesh)
    split = dryrun.split_census(specs, mesh)
    t0 = time.time()
    rec = dryrun.step_census(cfg, shape, mesh, specs)
    argument = sum(split.values())
    return {"arch": arch, "model": model, "layers": cfg.n_layers,
            "argument": argument,
            **{f"{k}_bytes": v for k, v in split.items()},
            "output": rec["output"], "temp": rec["temp"],
            "bytes_per_device": argument + rec["temp"],
            "flops": rec["flops"], "seconds": time.time() - t0}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", nargs=2, metavar=("ARCH", "MODEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.one[0], int(args.one[1]))))
        return 0
    env = dict(os.environ, OMP_NUM_THREADS="1")
    lines = []
    for arch in ARCHS:
        fits = None
        for n in MODELS:
            p = subprocess.run([sys.executable, __file__, "--one", arch,
                                str(n)], capture_output=True, text=True,
                               env=env)
            if p.returncode != 0:
                rec = {"arch": arch, "model": n,
                       "error": (p.stdout + p.stderr)[-2000:]}
            else:
                rec = json.loads(p.stdout.strip().splitlines()[-1])
                rec["fits"] = rec["bytes_per_device"] <= CARD_BYTES
                if rec["fits"] and fits is None:
                    fits = n
            print(json.dumps(rec), flush=True)
            lines.append(rec)
        summary = {"arch": arch, "least_model_that_fits": fits,
                   "card_bytes": CARD_BYTES}
        print(json.dumps(summary), flush=True)
        lines.append(summary)
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
