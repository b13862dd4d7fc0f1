"""Batched serving example on the PyTorch/CUDA port: prefill a prompt
batch, decode with the cached-state path (KV cache / MLA latent / SSM
state, per architecture).  On the card the attention layers run the
port's flash kernels at any head dim up to 256.

  PYTHONPATH=src python examples_torch/serve_batched.py [arch]
  PYTHONPATH=src python examples_torch/serve_batched.py [arch] --device cpu --kernel-mode torch
"""
import argparse

from repro_torch.configs import ARCH_IDS
from repro_torch.kernels import KERNEL_MODES
from repro_torch.launch import serve


def main(arch: str = "mamba2-130m", *, device="cuda",
         kernel_mode: str = "auto", batch: int = 4, prompt_len: int = 48,
         gen: int = 24, temperature: float = 0.8) -> dict:
    """Serve ``arch`` at smoke width; returns ``serve.run``'s output."""
    out = serve.run(arch, smoke=True, batch=batch, prompt_len=prompt_len,
                    gen=gen, temperature=temperature, device=device,
                    kernel_mode=kernel_mode)
    print(f"\n{arch}: generated {out['tokens'].shape[1]} tokens x "
          f"{out['tokens'].shape[0]} sequences")
    print("first sequence token ids:", out["tokens"][0][:16].tolist())
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="mamba2-130m",
                    choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kernel-mode", default="auto", choices=KERNEL_MODES)
    args = ap.parse_args()
    main(args.arch, device=args.device, kernel_mode=args.kernel_mode)
