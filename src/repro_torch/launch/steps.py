"""Step builders for serving (``repro.launch.steps`` for the port).

Plain closures over the config and the kernel mode; the JAX package jits
them and places them on a mesh, the port runs them eagerly on one device.
Training steps come with the next slice (``ROADMAP.md``).
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import decode_step, prefill


def make_prefill_step(cfg: ArchConfig, kernel_mode: str = "auto"):
    """(params, tokens [B, S], caches) -> (logits [B, V], caches)."""

    def step(params, tokens, caches):
        return prefill(params, tokens, cfg, caches, kernel_mode=kernel_mode)

    return step


def make_serve_step(cfg: ArchConfig):
    """One-token decode: (params, token [B, 1], pos, caches) -> (logits
    [B, V], caches).  ``pos`` is the current absolute position, a host int
    (the cache holds positions < pos).  Decode attends through its mask,
    not the flash kernel, so it takes no kernel mode."""

    def step(params, token, pos, caches):
        return decode_step(params, token, pos, cfg, caches)

    return step
