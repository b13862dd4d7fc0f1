#!/usr/bin/env python3
"""The kernel and plain runs of the paper's DEFAULT setting at T = 50, over
seeds: is their gap a fault or the runs' own spread?

    python3 tools/t50_spread.py [--seeds 0 1 2 3 4] [--aggs fedavg hieavg]
                                [--out FILE]

For each aggregator (``fedavg``: FedAvg without stragglers; ``hieavg``:
HieAvg under temporary stragglers, as ``chip_smoke.py``'s ``RUNS``) and
seed, one run with the kernels (``kernel_mode="auto"``) and one plain
(``"torch"``), in turns (an even seed runs the kernels first, an odd one
plain first).  Per run: final and best accuracy, final loss, wall seconds.
Per seed: the first global round at which the two runs part beyond the
engine-parity bounds (accuracy ``atol 0.02``, loss ``rtol = atol =
1e-3``; ``tests/test_engine_parity.py``), or null.  Per aggregator: the
paired differences kernel - plain of the final and best accuracy, their
mean and standard error, each mode's seed-to-seed standard deviation,
and the verdict: ``kernels_lower`` when the mean final difference lies
below minus twice its standard error.

Prints one JSON line per run and one summary line per aggregator; writes
them all to FILE with ``--out``.  Needs one CUDA device; exits 2
without one.  Imports only ``repro_torch``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AGGS = {"fedavg": ("fedavg", "none"), "hieavg": ("hieavg", "temporary")}
ACC_TOL, LOSS_TOL = 0.02, 1e-3
ROUNDS = 50


def parted(a, b) -> int | None:
    """The first round (1-based) at which two runs' rows part beyond the
    engine-parity bounds, or None."""
    for t, (ra, rb) in enumerate(zip(zip(a["accuracy"], a["loss"]),
                                     zip(b["accuracy"], b["loss"]))):
        if abs(ra[0] - rb[0]) > ACC_TOL or \
                abs(ra[1] - rb[1]) > LOSS_TOL + LOSS_TOL * abs(rb[1]):
            return t + 1
    return None


def mean_se(xs) -> tuple[float, float]:
    m = sum(xs) / len(xs)
    if len(xs) < 2:
        return m, float("nan")
    sd = math.sqrt(sum((x - m) ** 2 for x in xs) / (len(xs) - 1))
    return m, sd / math.sqrt(len(xs))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--aggs", nargs="+", choices=tuple(AGGS),
                    default=list(AGGS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import DEFAULT
    from repro_torch.fl import BHFLSimulator
    if not torch.cuda.is_available():
        print("t50_spread: no CUDA device is available", file=sys.stderr)
        return 2
    setting = dataclasses.replace(DEFAULT, t_global_rounds=ROUNDS)
    modes = ("auto", "torch")
    lines = []

    def emit(obj):
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    for name in args.aggs:
        agg, strag = AGGS[name]
        per_seed = []
        for seed in args.seeds:
            rows = {}
            order = modes if seed % 2 == 0 else modes[::-1]
            for mode in order:
                res = BHFLSimulator(setting, agg, strag, strag, seed=seed,
                                    device="cuda", kernel_mode=mode).run()
                acc = [float(x) for x in res.accuracy]
                loss = [float(x) for x in res.loss]
                rows[mode] = {"accuracy": acc, "loss": loss}
                emit({"run": name, "seed": seed, "mode": mode,
                      "final_accuracy": acc[-1], "best_accuracy": max(acc),
                      "final_loss": loss[-1], "wall_s": res.wall_time})
            k, p = rows["auto"], rows["torch"]
            per_seed.append({
                "seed": seed, "parted_at_round": parted(k, p),
                "final": (k["accuracy"][-1], p["accuracy"][-1]),
                "best": (max(k["accuracy"]), max(p["accuracy"]))})
        summary = {"summary": name, "rounds": ROUNDS,
                   "seeds": args.seeds,
                   "parted_at_round": [s["parted_at_round"]
                                       for s in per_seed]}
        for key in ("final", "best"):
            diffs = [s[key][0] - s[key][1] for s in per_seed]
            m, se = mean_se(diffs)
            summary[key] = {
                "kernel": [s[key][0] for s in per_seed],
                "plain": [s[key][1] for s in per_seed],
                "diff": diffs, "mean_diff": m, "se_diff": se,
                "sd_kernel": mean_se([s[key][0] for s in per_seed])[1]
                * math.sqrt(len(per_seed)),
                "sd_plain": mean_se([s[key][1] for s in per_seed])[1]
                * math.sqrt(len(per_seed))}
        f = summary["final"]
        summary["verdict"] = ("kernels_lower" if f["mean_diff"]
                              < -2 * f["se_diff"] else "within_spread")
        emit(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
