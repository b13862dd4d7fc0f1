"""Shared layers of the LLM zoo: RMS norm, the SwiGLU MLP, embeddings.

Port of ``repro.models.layers``: functional, spec-driven, the same
layouts and the same order of casts.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import hints
from .config import ArchConfig
from .spec import ParamSpec


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """float32 statistics, cast back to ``x.dtype``, then times the scale
    cast to ``x.dtype``."""
    x32 = x.to(torch.float32)
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def norm_spec(d: int, prefix_axes: tuple = (), prefix_shape: tuple = ()
              ) -> ParamSpec:
    return ParamSpec(prefix_shape + (d,), prefix_axes + (None,), init="ones")


# ----------------------------------------------------------------- dense mlp
def mlp_specs(cfg: ArchConfig, stacked: Optional[int]) -> dict:
    """SwiGLU MLP: gate/up [d_model, d_ff], down [d_ff, d_model]."""
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    d, f = cfg.d_model, cfg.d_ff
    return {
        "gate": ParamSpec(pre_s + (d, f), pre_a + ("embed", "mlp")),
        "up": ParamSpec(pre_s + (d, f), pre_a + ("embed", "mlp")),
        "down": ParamSpec(pre_s + (f, d), pre_a + ("mlp", "embed")),
        "norm": norm_spec(d, pre_a, pre_s),
    }


def mlp_apply(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    h = hints.tp_in(rms_norm(x, p["norm"], eps), p["gate"])
    out = (F.silu(h @ p["gate"]) * (h @ p["up"])) @ p["down"]
    return x + hints.seq(out)


# ---------------------------------------------------------------- embeddings
def embed_specs(cfg: ArchConfig) -> dict:
    out = {"tok": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                   ("embed", "vocab"))
    out["final_norm"] = norm_spec(cfg.d_model)
    return out


def embed_apply(p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The rows of the table, cast to ``compute_dtype`` (a gather commutes
    with the cast, so only the rows taken are cast)."""
    return hints.embed(hints.gather_weights(p["tok"]), tokens).to(
        compute_dtype)


def unembed_apply(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    p = hints.gather_weights(p)
    h = rms_norm(x, p["final_norm"], cfg.norm_eps)
    head = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return hints.tp_in(h, head) @ head.to(x.dtype)
