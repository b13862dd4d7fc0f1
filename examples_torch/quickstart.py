"""Quickstart: the paper's BHFL system on the PyTorch/CUDA port.

Five edge servers x five devices train the paper's CNN on non-IID data
with 20% temporary stragglers in both layers; HieAvg handles the missing
submissions; a Raft consortium blockchain of the edge servers commits one
block per global round.  Under ``kernel_mode="auto"`` on a GPU the round's
conv, SGD, aggregation and evaluation run in the port's CUDA kernels.

  PYTHONPATH=src python examples_torch/quickstart.py
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu --kernel-mode torch
"""
import argparse
import dataclasses

from repro_torch.configs import REDUCED
from repro_torch.core import (BoundParams, LatencyParams, omega_bound,
                              optimize_k)
from repro_torch.fl import BHFLSimulator
from repro_torch.kernels import KERNEL_MODES


def main(*, device="cuda", kernel_mode: str = "auto",
         t_global_rounds: int = 15, n_train: int = 2000, n_test: int = 400,
         steps_per_epoch: int = 8, init_params=None) -> dict:
    """Train, then pick K*; returns the printed numbers (``init_params``:
    an initial global model in the reference's layout, else the port's
    seeded draw; a hook for the tests that hold the driver to the
    reference, left unset in a run)."""
    # 1) train BHFL with HieAvg under stragglers -------------------------
    setting = dataclasses.replace(REDUCED, t_global_rounds=t_global_rounds)
    sim = BHFLSimulator(setting, aggregator="hieavg",
                        device_stragglers="temporary",
                        edge_stragglers="temporary",
                        n_train=n_train, n_test=n_test,
                        steps_per_epoch=steps_per_epoch, normalize=True,
                        device=device, kernel_mode=kernel_mode,
                        init_params=init_params)
    result = sim.run(progress=True)
    print(f"\nfinal accuracy {result.accuracy[-1]:.3f} "
          f"in {result.sim_clock[-1]:.0f} simulated seconds "
          f"({result.blocks} blocks committed, "
          f"chain_valid={result.chain_valid})")

    # 2) latency optimization: pick K* under the convergence + consensus
    #    constraints (Sec. 5.2) ------------------------------------------
    chain_latency = sim.chain.consensus_latency()
    res = optimize_k(LatencyParams(), lambda k: omega_bound(k, BoundParams()),
                     omega_bar=25.0, consensus_latency=chain_latency)
    print(f"optimal edge rounds K* = {res.k_star} "
          f"(total latency {res.latency:.0f}s, "
          f"consensus hidden in a {chain_latency:.2f}s window)")
    return {"accuracy": result.accuracy, "loss": result.loss,
            "sim_clock": result.sim_clock, "sim_energy": result.sim_energy,
            "blocks": result.blocks, "chain_valid": result.chain_valid,
            "chain_latency": chain_latency, "k_star": res.k_star,
            "k_latency": res.latency}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES)
    args = ap.parse_args()
    main(device=args.device, kernel_mode=args.kernel_mode)
