"""Accuracy-vs-latency Pareto front: consensus protocol x delay x K, one
bucketed sweep, on the PyTorch/CUDA port.

The paper's central tension (Sec. 5): more edge rounds K converge faster
per global round but stretch the wall clock, while the blockchain's
consensus latency hides inside the K-round edge window only when the
window is long enough (constraint C2).  A consensus-zoo x multiplier x K
grid runs as one bucketed sweep (the protocol is a data-batched field,
like the multiplier), every point carries simulated-clock AND
consensus-energy trajectories, and the accuracy-per-second Pareto front
falls out with the protocol's Joule bill beside it.

  PYTHONPATH=src python examples_torch/latency_pareto.py
  PYTHONPATH=src python examples_torch/latency_pareto.py --device cpu --kernel-mode torch
"""
import argparse
import dataclasses
import itertools

from repro_torch.configs import REDUCED
from repro_torch.fl import run_sweep
from repro_torch.kernels import KERNEL_MODES

CONSENSUS = ("raft", "pofel", "sharded")
CONS_MULTS = (1.0, 40.0)
K_GRID = (1, 2, 4)


def pareto_front(cands: list) -> list:
    """The candidates ``(seconds, accuracy, joules, overrides)`` that no
    other is both faster and at least as accurate as (or as fast and more
    accurate), fastest first."""
    front = [(s, a, e, ov) for s, a, e, ov in cands
             if not any(s2 < s and a2 >= a or (s2 <= s and a2 > a)
                        for s2, a2, _, _ in cands)]
    front.sort(key=lambda c: (c[0], c[1]))
    return front


def main(*, device="cuda", kernel_mode: str = "auto",
         t_global_rounds: int = 10, consensus: tuple = CONSENSUS,
         cons_mults: tuple = CONS_MULTS, k_grid: tuple = K_GRID,
         n_train: int = 1500, n_test: int = 300, steps_per_epoch: int = 2,
         bucket_cost: str = "measured", init_params=None) -> dict:
    """The grid, its table and its Pareto front; returns the printed
    numbers (``bucket_cost``, ``init_params``: as ``run_sweep``'s; hooks
    for the tests that hold the driver to the reference, left at their
    defaults in a run)."""
    setting = dataclasses.replace(REDUCED, t_global_rounds=t_global_rounds)
    overrides = [{"consensus": c, "consensus_mult": m, "k_edge_rounds": k}
                 for c, m, k in itertools.product(consensus, cons_mults,
                                                  k_grid)]
    sw = run_sweep(setting, overrides=overrides,
                   n_train=n_train, n_test=n_test,
                   steps_per_epoch=steps_per_epoch, normalize=True,
                   device=device, kernel_mode=kernel_mode,
                   bucket_cost=bucket_cost, init_params=init_params)

    # every point: (simulated seconds, best accuracy, consensus Joules)
    cands = []
    for p, (ov, _seed) in enumerate(sw.points):
        clock, acc = sw.latency_trajectory(p)
        _, energy = sw.energy_trajectory(p)
        cands.append((float(clock[-1]), float(acc.max()), float(energy[-1]),
                      ov))

    print("consensus  mult  K   sim_seconds  best_acc  acc_per_minute  "
          "energy_J")
    for secs, acc, joules, ov in cands:
        print(f"{ov['consensus']:>9}  {ov['consensus_mult']:4.0f}  "
              f"{ov['k_edge_rounds']}  {secs:11.1f}  {acc:8.3f}  "
              f"{60.0 * acc / secs:14.3f}  {joules:8.2f}")

    front = pareto_front(cands)
    print("\nPareto front (faster -> more accurate):")
    for secs, acc, joules, ov in front:
        print(f"  {ov['consensus']} mult={ov['consensus_mult']:.0f} "
              f"K={ov['k_edge_rounds']}: {acc:.3f} acc in {secs:.1f}s "
              f"({joules:.2f} J consensus)")
    best = max(cands, key=lambda c: c[1] / c[0])
    frugal = min(cands, key=lambda c: c[2])
    print(f"\nbest accuracy-per-second: {best[3]['consensus']} "
          f"mult={best[3]['consensus_mult']:.0f} "
          f"K={best[3]['k_edge_rounds']}")
    print(f"lowest consensus energy:  {frugal[3]['consensus']} "
          f"({frugal[2]:.2f} J over {setting.t_global_rounds} rounds; "
          f"{len(sw.points)}-point grid, one bucketed sweep)")
    return {"sweep": sw, "candidates": cands, "front": front,
            "best": best, "frugal": frugal}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES)
    args = ap.parse_args()
    main(device=args.device, kernel_mode=args.kernel_mode)
