"""Topology grids — N edges x J devices x K edge rounds — in a few batched
runs, on the PyTorch/CUDA port.

Changing ``n_edges``, ``j_per_edge`` or ``k_edge_rounds`` changes every
engine array shape.  The shape-bucketed planner
(``repro_torch.fl.sweep.plan_sweep``) groups the grid into a handful of
compatible-shape buckets — padded edges/devices carry zero aggregation
weight, padded edge rounds pass the carry through — and each bucket runs
as one stack of points.  The printed plan shows what the planner chose:
bucket count, per-bucket padded shapes, and the padded-compute waste vs.
both the no-padding ideal and padding every point to the global max.

  PYTHONPATH=src python examples_torch/sweep_topology.py
  PYTHONPATH=src python examples_torch/sweep_topology.py --device cpu --kernel-mode torch
"""
import argparse
import dataclasses
import itertools

from repro_torch.configs import REDUCED
from repro_torch.fl import plan_sweep, run_plan
from repro_torch.kernels import KERNEL_MODES


def main(*, device="cuda", kernel_mode: str = "auto",
         t_global_rounds: int = 8, edges: tuple = (2, 4),
         devices: tuple = (2, 4), k_grid: tuple = (1, 2),
         n_train: int = 1500, n_test: int = 300, steps_per_epoch: int = 2,
         bucket_cost: str = "measured", init_params=None) -> dict:
    """Plan and run the N x J x K grid; returns the plan's description and
    padding statistics, the ``SweepResult`` and the printed numbers
    (``bucket_cost``, ``init_params``: as ``plan_sweep``'s; hooks for the
    tests that hold the driver to the reference, left at their defaults
    in a run)."""
    setting = dataclasses.replace(REDUCED, t_global_rounds=t_global_rounds)

    overrides = [
        {"n_edges": n, "j_per_edge": j, "k_edge_rounds": k}
        for n, j, k in itertools.product(edges, devices, k_grid)
    ]

    plan = plan_sweep(
        setting,
        overrides=overrides,
        normalize=True,
        n_train=n_train, n_test=n_test, steps_per_epoch=steps_per_epoch,
        device=device, kernel_mode=kernel_mode, bucket_cost=bucket_cost,
        init_params=init_params,
    )
    described, stats, n_buckets = (plan.describe(), plan.padding_stats(),
                                   len(plan.buckets))
    print(described)
    print()
    grid = run_plan(plan)

    print("N  J  K   final_acc  best_acc  latency(s)")
    for p, (ov, _seed) in enumerate(grid.points):
        acc, _, _ = grid.trajectory(p)
        print(f"{ov['n_edges']}  {ov['j_per_edge']}  {ov['k_edge_rounds']}   "
              f"{acc[-1]:.4f}     {acc.max():.4f}    "
              f"{grid.sim_latency[p]:8.1f}")
    print(f"\n{len(grid.points)}-point N x J x K grid in "
          f"{n_buckets} batched call(s) "
          f"(padded-compute waste "
          f"{stats['padded_flop_frac']:.1%}, vs "
          f"{stats['single_bucket_flop_frac']:.1%} had every "
          f"point been padded to the single grid max).")
    return {"describe": described, "padding_stats": stats,
            "buckets": n_buckets, "sweep": grid}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES)
    args = ap.parse_args()
    main(device=args.device, kernel_mode=args.kernel_mode)
