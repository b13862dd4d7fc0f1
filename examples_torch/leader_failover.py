"""Single-point-of-failure drill, the paper's core motivation for BHFL, on
the PyTorch/CUDA port.

A centralized HFL deployment halts if the aggregation server dies.  Here
the Raft leader crashes mid-training: the consortium re-elects among the
surviving edge servers, the failed edge becomes a permanent straggler
(HieAvg estimates its submissions), and training finishes every round
with an intact block chain.

  PYTHONPATH=src python examples_torch/leader_failover.py
  PYTHONPATH=src python examples_torch/leader_failover.py --device cpu --kernel-mode torch
"""
import argparse
import dataclasses

from repro_torch.configs import REDUCED
from repro_torch.fl import BHFLSimulator
from repro_torch.kernels import KERNEL_MODES


def main(*, device="cuda", kernel_mode: str = "auto",
         t_global_rounds: int = 16, fail_leader_at: int = 8,
         n_train: int = 2000, n_test: int = 400, steps_per_epoch: int = 8,
         init_params=None) -> dict:
    """Crash the leader at round ``fail_leader_at``; returns the printed
    numbers (``init_params``: as ``quickstart.main``'s, a hook for the
    tests that hold the driver to the reference)."""
    setting = dataclasses.replace(REDUCED, t_global_rounds=t_global_rounds)
    sim = BHFLSimulator(setting, "hieavg", "temporary", "temporary",
                        normalize=True, fail_leader_at=fail_leader_at,
                        n_train=n_train, n_test=n_test,
                        steps_per_epoch=steps_per_epoch, device=device,
                        kernel_mode=kernel_mode, init_params=init_params)
    r = sim.run(progress=True)
    alive = int(sim.chain.alive.sum())

    print(f"\nleader crashed at round {fail_leader_at} — training continued:")
    print(f"  rounds completed : {len(r.accuracy)}/{setting.t_global_rounds}")
    print(f"  blocks committed : {r.blocks} (chain valid: {r.chain_valid})")
    print(f"  surviving edges  : {alive}/{sim.N} "
          f"(new leader: edge {sim.chain.leader})")
    print(f"  final accuracy   : {r.accuracy[-1]:.3f}")
    return {"accuracy": r.accuracy, "loss": r.loss, "sim_clock": r.sim_clock,
            "sim_energy": r.sim_energy, "blocks": r.blocks,
            "chain_valid": r.chain_valid, "alive": alive, "edges": sim.N,
            "leader": int(sim.chain.leader)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES)
    args = ap.parse_args()
    main(device=args.device, kernel_mode=args.kernel_mode)
