"""Multi-seed / multi-fraction grids as ONE batched engine run, on the
PyTorch/CUDA port.

The sweep fabric (``repro_torch.fl.sweep``) plans every grid point's
precomputed inputs (schedules, batch indices, decay factors) into stacked
buckets and runs each bucket as one stack of points through the engine,
on the card through the port's kernels.  Shape-preserving grids like this
one need no padding; see ``examples_torch/sweep_topology.py`` for grids
that change the topology itself.

  PYTHONPATH=src python examples_torch/sweep_grid.py
  PYTHONPATH=src python examples_torch/sweep_grid.py --device cpu --kernel-mode torch
"""
import argparse
import dataclasses

from repro_torch.configs import REDUCED
from repro_torch.fl import run_sweep
from repro_torch.kernels import KERNEL_MODES


def main(*, device="cuda", kernel_mode: str = "auto",
         t_global_rounds: int = 10, seeds: tuple = (0, 1),
         fractions: tuple = (0.2, 0.4), n_train: int = 1500,
         n_test: int = 300, steps_per_epoch: int = 4,
         bucket_cost: str = "measured", init_params=None) -> dict:
    """The grid (straggler fraction x seed); returns the ``SweepResult``
    and the printed numbers (``bucket_cost``, ``init_params``: as
    ``run_sweep``'s; hooks for the tests that hold the driver to the
    reference, left at their defaults in a run)."""
    setting = dataclasses.replace(REDUCED, t_global_rounds=t_global_rounds)
    grid = run_sweep(
        setting,
        seeds=seeds,
        overrides=[{"straggler_frac": f} for f in fractions],
        normalize=True,
        n_train=n_train, n_test=n_test, steps_per_epoch=steps_per_epoch,
        device=device, kernel_mode=kernel_mode, bucket_cost=bucket_cost,
        init_params=init_params,
    )

    print("point (overrides, seed)      final_acc  best_acc")
    for p, (ov, seed) in enumerate(grid.points):
        acc = grid.accuracy[p]
        print(f"{str(ov):28s} s={seed}  {acc[-1]:.4f}     {acc.max():.4f}")
    blocks = int(grid.blocks.sum())
    print(f"\n{len(grid.points)} runs x {setting.t_global_rounds} rounds "
          f"in one batched call; {blocks} blocks committed.")
    return {"sweep": grid, "final_acc": grid.accuracy[:, -1],
            "best_acc": grid.accuracy.max(axis=1), "blocks": blocks}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES)
    args = ap.parse_args()
    main(device=args.device, kernel_mode=args.kernel_mode)
