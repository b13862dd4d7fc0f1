"""Latency optimization walkthrough (paper Sec. 5 / Fig. 7) on the
PyTorch/CUDA port.

Shows the two K* selectors of the latency fabric side by side:

  * theoretical — ``optimize_k`` enumerates the dense K axis under the
    Theorem-2 convergence bound (C1) and the consensus-window constraint
    (C2), with the consensus latency from the closed-form Raft model
    (``expected_consensus_latency``);
  * empirical — a bucketed padded sweep over the K grid runs real training
    on the batched engine (on the card, through the port's kernels), and
    ``SweepResult.k_star_empirical`` picks the K whose *measured*
    convergence reaches a target accuracy in the least simulated time.

then prints the full feasibility table for one setting using the
vectorized dense-K model (``total_latency_k``/``edge_window_k``/
``omega_bound_k`` + ``optimize_k_masked``).

  PYTHONPATH=src python examples_torch/latency_optimization.py
  PYTHONPATH=src python examples_torch/latency_optimization.py --device cpu --kernel-mode torch
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import REDUCED
from repro_torch.core import (BoundParams, LatencyParams, RaftParams,
                              edge_window_k, expected_consensus_latency,
                              omega_bound, omega_bound_k, optimize_k,
                              optimize_k_masked, total_latency_k)
from repro_torch.fl import run_sweep
from repro_torch.kernels import KERNEL_MODES

LINKS = (0.05, 0.2, 0.5, 1.0, 2.0)


def main(*, device="cuda", kernel_mode: str = "auto",
         t_global_rounds: int = 10, k_grid: tuple = (1, 2, 4),
         n_train: int = 1500, n_test: int = 300, steps_per_epoch: int = 2,
         bucket_cost: str = "measured", init_params=None) -> dict:
    """The three sections; returns the printed numbers.  ``bucket_cost``
    and ``init_params`` go to ``run_sweep`` (``"proxy"`` plans as the
    reference does; ``init_params`` ``{seed: weights}``): hooks for the
    tests that hold the driver to the reference, left at their defaults
    in a run."""
    bp = BoundParams()
    lp = LatencyParams()          # paper's measured Raspberry Pi / EC2 numbers

    # 1) theoretical K* vs consensus latency (constraint C2) -------------
    # full per-round consensus (election + commit): the same L_bc the
    # engine clock charges
    print("consensus_latency -> K*  (total latency)  "
          "[closed-form Raft model]")
    theory = []
    for link in LINKS:
        lbc = expected_consensus_latency(RaftParams(link_latency=link), lp.N)
        res = optimize_k(lp, lambda k: omega_bound(k, bp), omega_bar=25.0,
                         consensus_latency=lbc)
        theory.append((lbc, res and res.k_star, res and res.latency))
        if res:
            print(f"  L_bc={lbc:5.2f}s -> K*={res.k_star}  "
                  f"({res.latency:8.1f}s)")
        else:
            print(f"  L_bc={lbc:5.2f}s -> infeasible")

    # 2) theoretical vs empirical K*: a bucketed sweep over the K grid --
    setting = dataclasses.replace(REDUCED, t_global_rounds=t_global_rounds)
    sw = run_sweep(setting, overrides=[{"k_edge_rounds": k} for k in k_grid],
                   n_train=n_train, n_test=n_test,
                   steps_per_epoch=steps_per_epoch, normalize=True,
                   device=device, kernel_mode=kernel_mode,
                   bucket_cost=bucket_cost, init_params=init_params)
    target = 0.6 * float(sw.accuracy.max())
    best, times = sw.k_star_empirical(target)
    # full election + commit, as the engine's clock charges it
    lbc = expected_consensus_latency(
        RaftParams(link_latency=setting.link_latency), setting.n_edges)
    res = optimize_k(LatencyParams(T=t_global_rounds),
                     lambda k: omega_bound(k, bp), omega_bar=25.0,
                     consensus_latency=lbc)
    print(f"\ntheoretical vs empirical K* (target acc {target:.2f}):")
    print("  K   time_to_target(s)   final_acc")
    for p, k in enumerate(k_grid):
        t = f"{times[p]:.1f}" if np.isfinite(times[p]) else "never"
        clock, acc = sw.latency_trajectory(p)
        print(f"  {k}   {t:>12}         {acc[-1]:.3f}")
    print(f"  -> theoretical K* = {res.k_star} (bound-driven), "
          f"empirical K* = {k_grid[best]} (measured convergence + clock)")

    # 3) feasibility table on the vectorized dense-K model ---------------
    print("\nfeasibility table (L_bc = 0.45s), dense-K masked argmin:")
    lat = total_latency_k(lp, 10)
    win = edge_window_k(lp, 10)
    om = omega_bound_k(bp, 10)
    k_star, k_lat, feas = optimize_k_masked(lat, om, win, 25.0, 0.45)
    print("  K   L(K)       edge_window  omega(K)   feasible")
    for i in range(10):
        print(f"  {i + 1:2d}  {float(lat[i]):9.1f}  {float(win[i]):6.2f}s"
              f"      {float(om[i]):8.3f}   {bool(feas[i])}")
    print(f"\nK* = {int(k_star)}")
    return {"theory": theory, "sweep": sw, "target": target,
            "k_star_empirical": k_grid[best], "times": times,
            "k_star_theory": res.k_star, "table_latency": lat.numpy(),
            "table_window": win.numpy(), "table_omega": om.numpy(),
            "table_feasible": feas.numpy(), "k_star_table": int(k_star)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES)
    args = ap.parse_args()
    main(device=args.device, kernel_mode=args.kernel_mode)
