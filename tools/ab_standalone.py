#!/usr/bin/env python3
"""The standalone runs of two trees of the port, side by side on one GPU.

    python3 tools/ab_standalone.py --parent DIR [--change DIR]

``DIR`` is the root of a checkout (``--change`` defaults to the one that
holds this script).  One process per tree, in turns (parent, change,
change, parent), each importing that tree's ``repro_torch`` and building
its kernels, runs with the kernels (``kernel_mode="auto"``):

  * the seven smoke configurations of ``chip_smoke.py`` (``RUNS``: DEFAULT
    cut to T = 4, every single-run aggregator, HieAvg with float32,
    bfloat16 and float8 history): their rows;
  * the whole DEFAULT HieAvg run (T = 50), twice: wall seconds and final
    accuracy (the smoke runs before it take the first-call costs);
  * the serve run of ``chip_smoke.py`` (h2o-danube-1.8b at full width,
    batch 2, a prompt of 8192 tokens) with 4 generated tokens: the SHA-256
    of its logits and tokens, and its prefill seconds;
  * the train run of ``chip_smoke.py`` (h2o-danube-1.8b at full width cut
    to 4 layers, one edge of two clients, 2 x 8192 tokens a client, T = 2,
    K = 2) after a short run that takes the first-call costs: seconds per
    edge round, tokens a second and the losses.

Prints one JSON line per process, then a summary: whether every smoke
configuration's rows are bitwise the same in all four processes, whether
the serve run's logits and tokens are, and the T = 50 wall seconds and
prefill seconds and the train round's seconds per tree.  Needs one CUDA
device; exits 2 without one.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy")


def one() -> dict:
    """The rows and the T = 50 run of the tree on ``PYTHONPATH``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (RUNS, SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT,
                            TRAIN_ARCH, TRAIN_KW, TRAIN_LAYERS)
    from repro_torch.configs import DEFAULT
    from repro_torch.fl import BHFLSimulator
    from repro_torch.kernels import build

    build.library()
    out: dict = {"tree": os.environ.get("PYTHONPATH", ""),
                 "device": torch.cuda.get_device_name(0)}
    setting = dataclasses.replace(DEFAULT, t_global_rounds=4)
    for label, (agg, strag, hname) in RUNS.items():
        res = BHFLSimulator(setting, agg, strag, strag, device="cuda",
                            kernel_mode="auto",
                            history_dtype=hname and getattr(torch, hname)
                            ).run()
        torch.cuda.synchronize()
        out[label] = {r: [float(v) for v in getattr(res, r)] for r in ROWS}
    runs = []
    for _ in range(2):
        res = BHFLSimulator(DEFAULT, "hieavg", "temporary", "temporary",
                            device="cuda", kernel_mode="auto").run()
        torch.cuda.synchronize()
        runs.append({"wall_s": res.wall_time,
                     "final_accuracy": float(res.accuracy[-1])})
    out[f"hieavg_t{DEFAULT.t_global_rounds}"] = runs
    from repro_torch.launch import serve
    res = serve.run(SERVE_ARCH, smoke=False, batch=SERVE_BATCH,
                    prompt_len=SERVE_PROMPT, gen=4, device="cuda",
                    progress=False)
    out["serve"] = {"sha256": hashlib.sha256(
        res["logits"].tobytes() + res["tokens"].tobytes()).hexdigest(),
        "prefill_s": res["t_prefill"]}
    from repro_torch.launch import train
    kw = dict(TRAIN_KW, n_layers=TRAIN_LAYERS, device="cuda")
    train.run(TRAIN_ARCH, **dict(kw, n_layers=1, steps=1, k_edge=1,
                                 seq=1024))
    res = train.run(TRAIN_ARCH, **kw)
    rounds = kw["steps"] * kw["k_edge"]
    tokens = rounds * kw["n_edges"] * kw["n_clients"] * kw["batch"] \
        * kw["seq"]
    out["train"] = {"s_per_edge_round": res["wall"] / rounds,
                    "tokens_per_s": tokens / res["wall"],
                    "losses": [float(x) for x in res["losses"]]}
    return out


def main() -> int:
    if "--one" in sys.argv[1:]:
        import torch
        if not torch.cuda.is_available():
            print("ab_standalone: no CUDA device is available",
                  file=sys.stderr)
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
    labels = [k for k in lines[0] if isinstance(lines[0][k], dict)
              and "accuracy" in lines[0][k]]
    key = next(k for k in lines[0] if k.startswith("hieavg_t"))
    summary = {
        "order": [x["side"] for x in lines],
        "rows_bitwise": {label: all(x[label] == lines[0][label]
                                    for x in lines) for label in labels},
        "serve_bitwise": all(x["serve"]["sha256"]
                             == lines[0]["serve"]["sha256"] for x in lines),
        "prefill_s": {side: [x["serve"]["prefill_s"] for x in lines
                             if x["side"] == side]
                      for side in ("parent", "change")},
        key: {side: [r for x in lines if x["side"] == side for r in x[key]]
              for side in ("parent", "change")},
        "train_s_per_edge_round": {
            side: [x["train"]["s_per_edge_round"] for x in lines
                   if x["side"] == side] for side in ("parent", "change")}}
    print(json.dumps({"ab_standalone": summary}), flush=True)
    return 0 if all(summary["rows_bitwise"].values()) \
        and summary["serve_bitwise"] else 1


if __name__ == "__main__":
    sys.exit(main())
