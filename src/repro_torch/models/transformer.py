"""Model assembly for the dense LLM zoo: a stack of ``n_units`` repeating
units of ``block_pattern`` layers, each leaf stacked ``[n_units, ...]``.

Port of ``repro.models.transformer`` for the ``"attn"`` layer kind (GQA
self-attention + SwiGLU MLP); the other kinds raise
``NotImplementedError`` until they are ported (``ROADMAP.md``).  Tail
layers and the encoder stack are not ported: ``repro_torch.configs``
refuses the configs that have them.  The stack is a Python loop that
indexes the stacked leaves, where the reference scans; ``remat`` (the
training loss only) checkpoints each unit, as the reference's
``jax.checkpoint`` of its scan body.

Three modes: ``train`` (full sequence, causal), ``prefill`` (train + cache
fill), ``decode`` (one token against the cache); ``loss_fn`` is the
training objective (mean next-token cross-entropy).  ``kernel_mode`` picks
the flash kernel or its plain version for full-sequence attention
(``kernels.build.use_kernel``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import attention as att
from .config import ArchConfig
from .layers import embed_apply, embed_specs, mlp_apply, mlp_specs, \
    unembed_apply

# ------------------------------------------------------------------- specs
def _layer_specs(cfg: ArchConfig, stacked: Optional[int]) -> dict:
    """An ``"attn"`` layer: GQA self-attention + SwiGLU MLP."""
    return {"mixer": att.attn_specs(cfg, stacked),
            "ffn": mlp_specs(cfg, stacked)}


def param_specs(cfg: ArchConfig) -> dict:
    return {"embed": embed_specs(cfg),
            "unit": {str(i): _layer_specs(cfg, cfg.n_units)
                     for i, _ in enumerate(cfg.block_pattern)}}


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> dict:
    """KV cache specs; ``dtype`` bf16 in production, f32 in tests."""
    return {"unit": {str(i): att.init_cache_spec(cfg, batch, max_len,
                                                 cfg.n_units, dtype)
                     for i, _ in enumerate(cfg.block_pattern)}}


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """Carry a JAX parameter (or cache) pytree, as numpy arrays, onto the
    port's: the same nested names, the stacked unit axis kept, each leaf in
    its own dtype (bfloat16 leaves through their bits)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = params_from_numpy(v, device)
            continue
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(a.view(np.int16))).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        out[k] = t.to(device)
    return out


# ------------------------------------------------------------------- apply
def _index(tree: dict, i: int) -> dict:
    """Unit ``i`` of a stacked tree (views, so cache writes go through)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _apply_layer(kind: str, p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                 mode: str, cache: Optional[dict], pos, kernel_mode: str):
    """One layer in the given mode; the cache is written in place."""
    if kind != "attn":
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    if mode == "train":
        x = att.attn_train(p["mixer"], x, cfg, kernel_mode=kernel_mode)
    elif mode == "prefill":
        x, _ = att.attn_prefill(p["mixer"], x, cfg, cache,
                                kernel_mode=kernel_mode)
    else:
        x, _ = att.attn_decode(p["mixer"], x, cfg, cache, pos)
    return mlp_apply(p["ffn"], x, cfg.norm_eps)


def _run_stack(params: dict, x: torch.Tensor, cfg: ArchConfig, *,
               mode: str, caches: Optional[dict], pos, kernel_mode: str,
               remat: bool = False) -> torch.Tensor:
    """The repeating units in order.  Caches are written in place.  With
    ``remat`` each unit runs under ``torch.utils.checkpoint``: only its
    input is kept for the backward, which runs the unit again (the flash
    forward included) before its gradient."""
    for u in range(cfg.n_units):
        def unit(x, u=u):
            up = _index(params["unit"], u)
            uc = _index(caches["unit"], u) if caches else {}
            for i, kind in enumerate(cfg.block_pattern):
                x = _apply_layer(kind, up[str(i)], x, cfg, mode=mode,
                                 cache=uc.get(str(i)), pos=pos,
                                 kernel_mode=kernel_mode)
            return x

        x = checkpoint(unit, x, use_reentrant=False) if remat else unit(x)
    return x


# ------------------------------------------------------------- public API
def forward_train(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                  kernel_mode: str = "auto"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V], aux loss (0 for dense kinds))."""
    x = embed_apply(params["embed"], tokens, cfg.torch_param_dtype)
    x = _run_stack(params, x, cfg, mode="train", caches=None, pos=None,
                   kernel_mode=kernel_mode)
    return (unembed_apply(params["embed"], x, cfg),
            torch.zeros((), device=x.device))


#: sequence-chunked cross-entropy: threshold and chunk length
LOSS_CHUNK = 512


def _nll(params: dict, x: torch.Tensor, labels: torch.Tensor,
         cfg: ArchConfig) -> torch.Tensor:
    """Per-position negative log-likelihood of ``labels`` (float32
    log-softmax of the logits).  A negative label reads class 0, which the
    caller's mask then drops (the reference's gather wraps it to the last
    class, as finite)."""
    logits = unembed_apply(params["embed"], x, cfg)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]


def loss_fn(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ArchConfig, *, remat: bool = False,
            kernel_mode: str = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy over the positions with ``labels >=
    0`` (tokens, labels [B, S]), as ``repro.models.loss_fn``; the dense
    kinds add no auxiliary loss.  Past ``LOSS_CHUNK`` positions, when the
    length is a multiple of it, the cross-entropy runs one chunk of
    positions at a time under ``torch.utils.checkpoint``, so the float32
    [B, S, V] logits never exist whole."""
    x = embed_apply(params["embed"], tokens, cfg.torch_param_dtype)
    x = _run_stack(params, x, cfg, mode="train", caches=None, pos=None,
                   kernel_mode=kernel_mode, remat=remat)
    valid = (labels >= 0).to(torch.float32)
    s = labels.shape[-1]
    if s <= LOSS_CHUNK or s % LOSS_CHUNK:
        nll = _nll(params, x, labels, cfg)
    else:
        nll = torch.cat([
            checkpoint(_nll, params, x[:, c:c + LOSS_CHUNK],
                       labels[:, c:c + LOSS_CHUNK], cfg, use_reentrant=False)
            for c in range(0, s, LOSS_CHUNK)], dim=1)
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            caches: dict, *, kernel_mode: str = "auto"):
    """tokens [B, S] -> (logits of the last position [B, V], caches filled
    in place)."""
    x = embed_apply(params["embed"], tokens, cfg.torch_param_dtype)
    x = _run_stack(params, x, cfg, mode="prefill", caches=caches, pos=None,
                   kernel_mode=kernel_mode)
    logits = unembed_apply(params["embed"], x[..., -1:, :], cfg)
    return logits[..., 0, :], caches


def decode_step(params: dict, token: torch.Tensor, pos: int,
                cfg: ArchConfig, caches: dict):
    """token [B, 1], pos the current position (a host int) -> (logits
    [B, V], caches updated in place)."""
    x = embed_apply(params["embed"], token, cfg.torch_param_dtype)
    x = _run_stack(params, x, cfg, mode="decode", caches=caches, pos=pos,
                   kernel_mode="auto")
    logits = unembed_apply(params["embed"], x, cfg)
    return logits[..., 0, :], caches
