"""End-to-end driver: hierarchical BHFL training of a transformer LM on
the PyTorch/CUDA port.

Runs the framework-scale path (HieAvg at both layers, Raft consensus,
checkpointing) on a reduced h2o-danube variant: 40 global rounds of a
~1M-parameter model.  The whole T x K-round run takes the engine path
(``fused=True``, the default): batches, straggler masks and the lr
schedule drawn up front, the Raft chain replayed with its election and
commit latency feeding a simulated clock.  On the card every attention
layer runs the port's flash kernels, forward and backward; HieAvg
aggregates in plain PyTorch, as the reference's step does in jnp.

  PYTHONPATH=src python examples_torch/train_bhfl_llm.py
  PYTHONPATH=src python examples_torch/train_bhfl_llm.py --device cpu --kernel-mode torch
"""
import argparse
import tempfile

from repro_torch.kernels import KERNEL_MODES
from repro_torch.launch import train


def main(*, device="cuda", kernel_mode: str = "auto", steps: int = 40,
         k_edge: int = 2, n_clients: int = 4, batch: int = 4, seq: int = 64,
         straggler_frac: float = 0.25) -> dict:
    """Train with checkpoints into a temporary directory; returns
    ``train.run``'s output."""
    with tempfile.TemporaryDirectory() as ckpt:
        out = train.run("h2o-danube-1.8b", smoke=True, steps=steps,
                        k_edge=k_edge, n_clients=n_clients, batch=batch,
                        seq=seq, straggler_frac=straggler_frac,
                        normalize=True, ckpt_dir=ckpt, device=device,
                        kernel_mode=kernel_mode)
    print(f"\nloss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"over {len(out['losses'])} global rounds "
          f"({out['sim_clock'][-1]:.0f} simulated seconds)")
    print(f"blockchain: {out['blocks']} blocks, valid={out['chain_valid']}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES)
    args = ap.parse_args()
    result = main(device=args.device, kernel_mode=args.kernel_mode)
    if not result["losses"][-1] < result["losses"][0]:
        raise SystemExit("training must make progress: loss "
                         f"{result['losses'][0]:.3f} -> "
                         f"{result['losses'][-1]:.3f}")
