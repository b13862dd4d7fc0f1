"""Model assembly for the LLM zoo: a stack of ``n_units`` repeating units of
``block_pattern`` layers, each leaf stacked ``[n_units, ...]``, the
non-repeating ``tail_pattern`` layers after them (unstacked leaves,
``tail.<i>``), and an optional encoder stack (``encoder.unit.0``, stacked
``[encoder.n_layers, ...]``) over the stubbed frontend's embeddings.

Port of ``repro.models.transformer``, every layer kind of it:

  attn      GQA self-attention + SwiGLU MLP
  mla       multi-head latent attention + SwiGLU MLP
  attn_moe  GQA self-attention + MoE MLP
  mla_moe   multi-head latent attention + MoE MLP
  rec       RG-LRU recurrent block + SwiGLU MLP
  ssd       Mamba-2 SSD block (no separate MLP)
  xattn     gated cross-attention to the memory + SwiGLU MLP
  enc_attn  the encoder's non-causal self-attention + SwiGLU MLP

Each stack is a Python loop that indexes the stacked leaves, where the
reference scans; ``remat`` (the training loss only) checkpoints each unit,
and each encoder layer, as the reference's ``jax.checkpoint`` of its scan
body; the tail runs after the units, outside any checkpoint, as the
reference runs it after its scan.  The recurrent layers' caches (``h``
and the conv window) are float32 whatever the KV caches' dtype.  The MoE
layers' load-balance loss (``aux``) is summed over the layers as the
reference carries it through its scan: a checkpointed unit returns it
beside its output, so the backward recomputes it and its gradient reaches
the routers; ``forward_train`` returns it and ``loss_fn`` adds it.

The memory that ``xattn`` attends to is the encoder's output over the
frame embeddings (enc-dec), or the patch embeddings themselves (the VLM,
whose vision tower is a stub in the reference too).  ``forward_train``,
``loss_fn`` and ``prefill`` take the raw embeddings (``memory_embeds``)
and encode them inside; ``decode_step`` takes the encoded memory
(``memory``), which ``encode`` gives, and so may ``prefill``, so that a
serve run encodes once.

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
from . import hints
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rg_mod
from . import ssd as ssd_mod
from .config import ArchConfig
from .layers import embed_apply, embed_specs, mlp_apply, mlp_specs, \
    unembed_apply

#: each layer kind's mixer and feed-forward block (None: none)
MIXER = {"attn": "attn", "attn_moe": "attn", "mla": "mla", "mla_moe": "mla",
         "rec": "rec", "ssd": "ssd", "xattn": "xattn",
         "enc_attn": "enc_attn"}
FFN = {"attn": "mlp", "attn_moe": "moe", "mla": "mlp", "mla_moe": "moe",
       "rec": "mlp", "ssd": None, "xattn": "mlp", "enc_attn": "mlp"}
#: the recurrent mixers' train, prefill and decode functions
RECURRENT = {"rec": (rg_mod.rglru_train, rg_mod.rglru_prefill,
                     rg_mod.rglru_decode),
             "ssd": (ssd_mod.ssd_train, ssd_mod.ssd_prefill,
                     ssd_mod.ssd_decode)}


# ------------------------------------------------------------------- specs
def _layer_specs(kind: str, cfg: ArchConfig, stacked: Optional[int]) -> dict:
    """A layer's mixer (self- or cross-attention, MLA, RG-LRU or SSD) and
    its feed-forward block (SwiGLU MLP or MoE; none after SSD)."""
    mixer, ffn = MIXER[kind], FFN[kind]
    if mixer == "mla":
        out = {"mixer": mla_mod.mla_specs(cfg, stacked)}
    elif mixer == "rec":
        out = {"mixer": rg_mod.rglru_specs(cfg, stacked)}
    elif mixer == "ssd":
        out = {"mixer": ssd_mod.ssd_specs(cfg, stacked)}
    else:
        out = {"mixer": att.attn_specs(cfg, stacked, cross=mixer == "xattn")}
    if ffn == "mlp":
        out["ffn"] = mlp_specs(cfg, stacked)
    elif ffn == "moe":
        out["ffn"] = moe_mod.moe_specs(cfg, stacked)
    return out


def param_specs(cfg: ArchConfig) -> dict:
    specs = {"embed": embed_specs(cfg),
             "unit": {str(i): _layer_specs(k, cfg, cfg.n_units)
                      for i, k in enumerate(cfg.block_pattern)}}
    if cfg.tail_pattern:
        specs["tail"] = {str(i): _layer_specs(k, cfg, None)
                         for i, k in enumerate(cfg.tail_pattern)}
    if cfg.encoder:
        specs["encoder"] = {"unit": {"0": _layer_specs(
            "enc_attn", cfg, cfg.encoder.n_layers)}}
    return specs


def _layer_cache_spec(kind: str, cfg: ArchConfig, batch: int, max_len: int,
                      stacked: Optional[int], dtype) -> Optional[dict]:
    mixer = MIXER[kind]
    if mixer == "attn":
        return att.init_cache_spec(cfg, batch, max_len, stacked, dtype)
    if mixer == "mla":
        return mla_mod.mla_cache_spec(cfg, batch, max_len, stacked, dtype)
    if mixer == "rec":
        return rg_mod.rglru_cache_spec(cfg, batch, stacked)
    if mixer == "ssd":
        return ssd_mod.ssd_cache_spec(cfg, batch, stacked)
    return None  # cross-attention: a static memory, no cache


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> dict:
    """The cache specs of the layers that keep one: KV caches, MLA's
    compressed ``c_kv``/``k_rope`` and the recurrent layers' state and conv
    window, for the units (stacked) and the tail (cross-attention attends
    to a static memory and keeps no cache).  ``dtype`` is the KV caches'
    (bf16 in production, f32 in tests); the recurrent states are float32
    whatever it is, as the reference keeps them."""
    out = {"unit": {
        str(i): cs for i, k in enumerate(cfg.block_pattern)
        if (cs := _layer_cache_spec(k, cfg, batch, max_len, cfg.n_units,
                                    dtype)) is not None}}
    if cfg.tail_pattern:
        out["tail"] = {
            str(i): cs for i, k in enumerate(cfg.tail_pattern)
            if (cs := _layer_cache_spec(k, cfg, batch, max_len, None, dtype))
            is not None}
    return out


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """Carry a JAX parameter (or cache) pytree, as numpy arrays, onto the
    port's: the same nested names, the stacked unit axis kept, each leaf in
    its own dtype (bfloat16 leaves through their bits)."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else leaf_from_numpy(v).to(device) for k, v in tree.items()}


def leaf_from_numpy(v) -> torch.Tensor:
    """One numpy leaf as a CPU tensor of its dtype (a copy; bfloat16
    through its bits)."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- apply
def _index(tree: dict, i: int) -> dict:
    """Unit ``i`` of a stacked tree (views, so cache writes go through)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _apply_layer(kind: str, p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                 mode: str, cache: Optional[dict], pos, memory,
                 kernel_mode: str):
    """One layer in the given mode -> (x, its MoE aux loss or None); the
    cache is written in place.  The encoder's layers and cross-attention
    run as in training in every mode (they keep no cache)."""
    mixer = MIXER[kind]
    if mixer in RECURRENT:
        train, prefill_, decode = RECURRENT[mixer]
        if mode == "train":
            x = train(p["mixer"], x, cfg)
        elif mode == "prefill":
            x, _ = prefill_(p["mixer"], x, cfg, cache)
        else:
            x, _ = decode(p["mixer"], x, cfg, cache)
    elif mixer == "mla":
        if mode == "train":
            x = mla_mod.mla_train(p["mixer"], x, cfg,
                                  kernel_mode=kernel_mode)
        elif mode == "prefill":
            x, _ = mla_mod.mla_prefill(p["mixer"], x, cfg, cache,
                                       kernel_mode=kernel_mode)
        else:
            x, _ = mla_mod.mla_decode(p["mixer"], x, cfg, cache, pos)
    elif mixer == "enc_attn":
        x = att.attn_train(p["mixer"], x, cfg, causal=False,
                           kernel_mode=kernel_mode)
    elif mixer == "xattn":
        if memory is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             "the memory (memory_embeds or memory)")
        x = att.xattn_train(p["mixer"], x, memory, cfg,
                            kernel_mode=kernel_mode)
    elif mode == "train":
        x = att.attn_train(p["mixer"], x, cfg, kernel_mode=kernel_mode)
    elif mode == "prefill":
        x, _ = att.attn_prefill(p["mixer"], x, cfg, cache,
                                kernel_mode=kernel_mode)
    else:
        x, _ = att.attn_decode(p["mixer"], x, cfg, cache, pos)
    if FFN[kind] == "moe":
        return moe_mod.moe_apply(p["ffn"], x, cfg)
    if FFN[kind] == "mlp":
        x = mlp_apply(p["ffn"], x, cfg.norm_eps)
    return x, None


def _run_stack(params: dict, x: torch.Tensor, cfg: ArchConfig, pattern,
               n_units: int, *, mode: str, caches: Optional[dict], pos,
               memory, kernel_mode: str, remat: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``n_units`` stacked units of ``params["unit"]`` in order, each
    the layers of ``pattern`` -> (x, the MoE layers' aux loss summed,
    float32 0-dim).  Caches are written in place.  With ``remat`` each
    unit runs under ``torch.utils.checkpoint``: only its input and the
    memory are kept for the backward, which runs the unit again (the flash
    forward and the routers included) before its gradient."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for u in range(n_units):
        def unit(x, memory, u=u):
            up = hints.gather_weights(_index(params["unit"], u))
            uc = _index(caches["unit"], u) if caches else {}
            unit_aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, kind in enumerate(pattern):
                x, a = _apply_layer(kind, up[str(i)], x, cfg, mode=mode,
                                    cache=uc.get(str(i)), pos=pos,
                                    memory=memory, kernel_mode=kernel_mode)
                x = hints.seq(x)
                if a is not None:
                    unit_aux = unit_aux + a
            return x, unit_aux

        x = hints.seq(x)
        x, unit_aux = checkpoint(unit, x, memory, use_reentrant=False) \
            if remat else unit(x, memory)
        aux = aux + unit_aux
    return x, aux


def _decoder(params: dict, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
             caches: Optional[dict], pos, memory, kernel_mode: str,
             remat: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The decoder's units (``_run_stack``), then its tail layers, outside
    any checkpoint (the reference checkpoints only its scan's body)."""
    x, aux = _run_stack(params, x, cfg, cfg.block_pattern, cfg.n_units,
                        mode=mode, caches=caches, pos=pos, memory=memory,
                        kernel_mode=kernel_mode, remat=remat)
    tc = caches.get("tail", {}) if caches else {}
    for i, kind in enumerate(cfg.tail_pattern):
        x, a = _apply_layer(kind, hints.gather_weights(params["tail"][str(i)]),
                            x, cfg, mode=mode, cache=tc.get(str(i)), pos=pos,
                            memory=memory, kernel_mode=kernel_mode)
        x = hints.seq(x)
        if a is not None:
            aux = aux + a
    return x, aux


def _encode(params: dict, memory_embeds: torch.Tensor, cfg: ArchConfig, *,
            remat: bool, kernel_mode: str) -> torch.Tensor:
    """The encoder stack over the stubbed frontend's embeddings: its own
    stacked length (``encoder.n_layers``), one ``enc_attn`` layer a unit."""
    return _run_stack(params["encoder"], memory_embeds, cfg, ("enc_attn",),
                      cfg.encoder.n_layers, mode="train", caches=None,
                      pos=None, memory=None, kernel_mode=kernel_mode,
                      remat=remat)[0]


def _memory(params: dict, cfg: ArchConfig, memory_embeds, *, remat: bool,
            kernel_mode: str):
    """The cross-attention memory of the raw embeddings: encoded (enc-dec),
    or the VLM's patch embeddings as they are (its projector's output)."""
    if memory_embeds is None:
        return None
    if cfg.encoder:
        return _encode(params, memory_embeds, cfg, remat=remat,
                       kernel_mode=kernel_mode)
    return memory_embeds


# ------------------------------------------------------------- public API
def forward_train(params: dict, tokens: torch.Tensor, cfg: ArchConfig, *,
                  memory_embeds: Optional[torch.Tensor] = None,
                  kernel_mode: str = "auto"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] (and the raw memory embeddings [B, S_mem, D] of a
    model with cross-attention) -> (logits [B, S, V], the MoE layers' aux
    loss, float32 0-dim: 0 without MoE layers)."""
    x = embed_apply(params["embed"], tokens, cfg.torch_param_dtype)
    mem = _memory(params, cfg, memory_embeds, remat=False,
                  kernel_mode=kernel_mode)
    x, aux = _decoder(params, x, cfg, mode="train", caches=None, pos=None,
                      memory=mem, kernel_mode=kernel_mode)
    return unembed_apply(params["embed"], x, cfg), aux


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
            cfg: ArchConfig, *, memory_embeds=None, remat: bool = False,
            kernel_mode: str = "auto") -> torch.Tensor:
    """Mean next-token cross-entropy over the positions with ``labels >=
    0`` (tokens, labels [B, S]) plus the MoE layers' load-balance loss, as
    ``repro.models.loss_fn``.  ``memory_embeds``: the raw memory
    [B, S_mem, D], encoded inside (under ``remat`` too).  Past
    ``LOSS_CHUNK`` positions, when the length is a multiple of it, the
    cross-entropy runs one chunk of positions at a time under
    ``torch.utils.checkpoint``, so the float32 [B, S, V] logits never exist
    whole."""
    x = embed_apply(params["embed"], tokens, cfg.torch_param_dtype)
    mem = _memory(params, cfg, memory_embeds, remat=remat,
                  kernel_mode=kernel_mode)
    x, aux = _decoder(params, x, cfg, mode="train", caches=None, pos=None,
                      memory=mem, kernel_mode=kernel_mode, remat=remat)
    x = hints.whole_seq(x)
    valid = (labels >= 0).to(torch.float32)
    s = labels.shape[-1]
    if s <= LOSS_CHUNK or s % LOSS_CHUNK:
        nll = _nll(params, x, labels, cfg)
    else:
        nll = torch.cat([
            checkpoint(_nll, params, x[:, c:c + LOSS_CHUNK],
                       labels[:, c:c + LOSS_CHUNK], cfg, use_reentrant=False)
            for c in range(0, s, LOSS_CHUNK)], dim=1)
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0) + aux


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            caches: dict, *, memory_embeds=None, memory=None,
            kernel_mode: str = "auto"):
    """tokens [B, S] -> (logits of the last position [B, V], caches filled
    in place).  A model with cross-attention takes either the raw memory
    ``memory_embeds`` (encoded here, as the reference's ``prefill``) or
    the encoded ``memory`` (``encode``'s output, as ``decode_step`` takes
    it), not both."""
    if memory_embeds is not None and memory is not None:
        raise ValueError("prefill takes memory_embeds or memory, not both")
    x = embed_apply(params["embed"], tokens, cfg.torch_param_dtype)
    if memory is None:
        memory = _memory(params, cfg, memory_embeds, remat=False,
                         kernel_mode=kernel_mode)
    x, _ = _decoder(params, x, cfg, mode="prefill", caches=caches,
                    pos=None, memory=memory, kernel_mode=kernel_mode)
    logits = unembed_apply(params["embed"], x[..., -1:, :], cfg)
    return logits[..., 0, :], caches


def encode(params: dict, memory_embeds: torch.Tensor, cfg: ArchConfig, *,
           remat: bool = False, kernel_mode: str = "auto"):
    """The cross-attention memory of the raw embeddings: the encoder run
    once (enc-dec serving runs it at prefill time), or the VLM's patch
    embeddings as they are; None for None."""
    return _memory(params, cfg, memory_embeds, remat=remat,
                   kernel_mode=kernel_mode)


def decode_step(params: dict, token: torch.Tensor, pos: int,
                cfg: ArchConfig, caches: dict, *, memory=None):
    """token [B, 1], pos the current position (a host int) -> (logits
    [B, V], caches updated in place).  ``memory`` is the *encoded*
    cross-attention memory (``encode``'s output): the encoder runs once at
    prefill, not per decode step."""
    x = embed_apply(params["embed"], token, cfg.torch_param_dtype)
    x, _ = _decoder(params, x, cfg, mode="decode", caches=caches, pos=pos,
                    memory=memory, kernel_mode="auto")
    logits = unembed_apply(params["embed"], x, cfg)
    return logits[..., 0, :], caches
