"""Batched serving driver: prefill a prompt batch, decode N tokens.

Port of ``repro.launch.serve`` for the LLM zoo, on one GPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \\
      --batch 4 --prompt-len 32 --gen 16 [--no-smoke] [--n-layers N] \\
      [--device cpu]

The weights are random, drawn from ``seed`` on the device they run on, in
the config's own ``param_dtype`` (bfloat16 at full width; the reference's
``run`` leaves them float32, which its bfloat16 embedding then rejects).
The KV caches are float32 at smoke width and bfloat16 at full width, as
the reference makes them.  A model with cross-attention reads zero memory
of the stubbed frontend's shape (``inputs.memory_shape``) in the
parameters' dtype, as the reference's driver feeds it.  The encoder runs
once, inside the timed prefill, and every decode step reads its output;
the reference's driver hands its decode steps the raw embeddings instead,
against ``decode_step``'s own contract (``ROADMAP.md``, "Faults of the
reference").
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, cut_depth, get_config, get_smoke
from repro_torch.data import lm_tokens
from repro_torch.fl.simulator import resolve_device
from repro_torch.kernels.build import KERNEL_MODES
from repro_torch.launch.inputs import memory_shape
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import (cache_specs, encode, init_from_specs,
                                param_specs)
from repro_torch.models.spec import draw_leaves


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_params(cfg, seed: int, device) -> dict:
    """Random weights in ``cfg.param_dtype``, drawn on ``device`` from a
    generator there seeded with ``seed``: the same seed and device give the
    same weights."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return init_from_specs(param_specs(cfg), g, device, cfg.torch_param_dtype)


def draw_params(cfg, seed: int, device):
    """``make_params``' weights one leaf at a time: ``(path, leaf)`` pairs
    from the same generator in the same order, each leaf float32 (its cast
    to ``cfg.param_dtype`` is ``make_params``' leaf bitwise), so that a
    caller need never hold the whole model (``sharding.shard_leaves``).
    The draws depend on the card's model, not on which card of a node."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return draw_leaves(param_specs(cfg), g, device)


def make_caches(cfg, batch: int, max_len: int, device, *,
                smoke: bool) -> dict:
    """Zeroed KV caches: float32 at smoke width, bfloat16 at full width."""
    return init_from_specs(
        cache_specs(cfg, batch, max_len,
                    dtype=torch.float32 if smoke else torch.bfloat16),
        None, device)


def run(arch: str, *, smoke: bool = True, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, temperature: float = 0.0,
        seed: int = 0, device=None, kernel_mode: str = "auto",
        progress: bool = True, n_layers: Optional[int] = None) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens (``lm_tokens``
    from ``seed``) and decode ``gen`` tokens.

    ``device=None`` means ``"cuda"`` and raises without a GPU.
    ``n_layers`` cuts the config's depth (``configs.cut_depth``; None: its
    own), for a model too deep for one card (grok-1-314b).  Greedy at
    ``temperature == 0``; above it, sampling from a ``torch.Generator``
    seeded with ``seed + 2``, whose draws differ from ``jax.random``'s.

    Returns ``tokens`` [batch, gen] int32, ``logits`` [batch, gen, vocab]
    float32 (the logits each token was picked from: the prefill's last
    position, then each decode step's), and ``t_prefill`` (the encoder's
    run included) / ``t_decode`` in seconds, each ended by a device
    synchronize.
    """
    dev = resolve_device(device)
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"unknown kernel_mode {kernel_mode!r}")
    if kernel_mode == "cuda" and dev.type != "cuda":
        raise ValueError("kernel_mode='cuda' needs device='cuda'")
    cfg = get_smoke(arch) if smoke else get_config(arch)
    if n_layers is not None:
        cfg = cut_depth(cfg, n_layers)
    max_len = prompt_len + gen

    params = make_params(cfg, seed, dev)
    caches = make_caches(cfg, batch, max_len, dev, smoke=smoke)
    prompts = torch.as_tensor(lm_tokens(batch, prompt_len, cfg.vocab,
                                        seed=seed), device=dev).long()
    ms = memory_shape(cfg)
    raw = (torch.zeros((batch,) + ms, dtype=cfg.torch_param_dtype,
                       device=dev) if ms is not None else None)
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(seed + 2)

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, -1)
            return torch.multinomial(probs, 1, generator=sampler)[:, 0]
        return torch.argmax(logits, -1)

    prefill = make_prefill_step(cfg, kernel_mode)
    decode = make_serve_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    memory = encode(params, raw, cfg, kernel_mode=kernel_mode)
    logits, caches = prefill(params, prompts, caches, memory=memory)
    seen, toks = [logits], [pick(logits)]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, caches = decode(params, toks[-1][:, None], prompt_len + i,
                                caches, memory)
        seen.append(logits)
        toks.append(pick(logits))
    out = torch.stack(toks, dim=1)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    if progress:
        print(f"  prefill {prompt_len} toks x{batch}: {t_prefill:.2f}s; "
              f"decode {gen} toks: {t_decode:.2f}s "
              f"({gen * batch / max(t_decode, 1e-9):.1f} tok/s)")
    return {"tokens": out.to(torch.int32).cpu().numpy(),
            "logits": torch.stack(seen, dim=1).float().cpu().numpy(),
            "t_prefill": t_prefill, "t_decode": t_decode}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--kernel-mode", choices=KERNEL_MODES, default="auto")
    args = ap.parse_args()
    out = run(args.arch, smoke=args.smoke, batch=args.batch,
              prompt_len=args.prompt_len, gen=args.gen,
              temperature=args.temperature, seed=args.seed,
              device=args.device, kernel_mode=args.kernel_mode,
              n_layers=args.n_layers)
    print("sample token ids:", out["tokens"][0, :10])


if __name__ == "__main__":
    main()
