"""GQA attention with RoPE, qk-norm, sliding window, a KV cache and gated
cross-attention.

Port of ``repro.models.attention``:

  * ``attn_train``   — full-sequence causal (optionally windowed) attention,
    or non-causal (the encoder's);
  * ``attn_prefill`` — the same, and it also fills the KV cache;
  * ``attn_decode``  — one query token against the cache;
  * ``xattn_train``  — gated cross-attention to a static memory (no RoPE,
    no mask, no cache); ``xattn_decode`` is the same for one query row.

Caches are dicts ``{"k": [B, S, Hkv, Dh], "v": ...}``; a sliding-window
cache is a ring that holds the last ``window`` positions.  The port fills
and updates the cache tensors in place (the returned caches are the same
tensors); the reference returns new arrays.  Full-sequence attention goes
to ``kernels.ops.flash_attention`` (the CUDA kernel, or its plain version
per ``kernel_mode``); decode, with its precomputed mask, to
``_sdpa_block``.  The reference's sharding hints (``HEAD_SPEC``,
``KV_GATHER_SPEC``) are ``models.hints``' ``heads`` and ``kv_gather``,
applied to q, k and v as they are made; a cache write goes through
``hints.write``, which on a DTensor cache writes each rank's own shard.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as _ops

from . import hints
from .config import ArchConfig
from .layers import norm_spec, rms_norm
from .spec import ParamSpec

NEG_INF = -2.0 ** 30  # large-negative that survives bf16

f32 = torch.float32


# ------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """Made on ``device``: a host-to-device copy here would wait for the
    device at every layer."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=f32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, Dh]; pos: [..., S] absolute positions.  Split halves
    (not interleaved), float32 math, cast back to ``x.dtype``."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # [Dh/2]
    ang = pos[..., None].to(f32) * freqs                         # [..., S, Dh/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ specs
def attn_specs(cfg: ArchConfig, stacked: Optional[int],
               cross: bool = False) -> dict:
    """The projections and norms; ``cross`` adds the cross-attention's
    tanh gate ``xattn_gate`` [stacked, 1], zeros (the layer starts as an
    identity)."""
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    out = {
        "wq": ParamSpec(pre_s + (d, h, dh), pre_a + ("embed", "heads", None)),
        "wk": ParamSpec(pre_s + (d, hkv, dh),
                        pre_a + ("embed", "kv_heads", None)),
        "wv": ParamSpec(pre_s + (d, hkv, dh),
                        pre_a + ("embed", "kv_heads", None)),
        "wo": ParamSpec(pre_s + (h, dh, d), pre_a + ("heads", None, "embed")),
        "norm": norm_spec(d, pre_a, pre_s),
    }
    if cfg.qk_norm:
        out["q_norm"] = norm_spec(dh, pre_a, pre_s)
        out["k_norm"] = norm_spec(dh, pre_a, pre_s)
    if cross:
        out["xattn_gate"] = ParamSpec(pre_s + (1,), pre_a + (None,),
                                      init="zeros")
    return out


# ------------------------------------------------------------------ masks
def causal_mask(s_q: int, s_kv: int, q_offset: int = 0,
                window: Optional[int] = None, device="cpu") -> torch.Tensor:
    """[s_q, s_kv] additive mask; window = sliding-window size (None = full)."""
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_kv, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF)


def _sdpa_block(q, k, v, bias):
    """q: [B,Sq,H,Dh]; k/v: [B,Skv,Hkv,Dh] (GQA-expanded inside); ``bias``
    broadcasts over [B, Hkv, G, Sq, Skv].  float32 math."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, sq, hkv, h // hkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.to(f32), k.to(f32)) \
        / math.sqrt(dh)
    probs = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(f32))
    return out.reshape(b, sq, h, dh).to(v.dtype)


def _sdpa(q, k, v, *, causal: bool, window=None, q_offset: int = 0,
          bias=None, kernel_mode: str = "auto"):
    """With a ``bias`` (decode) the masked softmax of ``_sdpa_block``; a
    full sequence (``sq > 1``) goes to the flash kernel or its plain
    version per ``kernel_mode``; a single query row without a bias to
    ``_sdpa_block`` with the causal mask (the zero mask where neither
    causal nor windowed: cross-attention's decode), as the reference
    does."""
    sq, skv = q.shape[1], k.shape[1]
    if bias is None and sq > 1:
        return _ops.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, mode=kernel_mode)
    m = bias if bias is not None else (
        causal_mask(sq, skv, q_offset=q_offset, window=window,
                    device=q.device)
        if (causal or window) else torch.zeros((), device=q.device))
    if _ops.is_dtensor(q):
        # one query row: each rank's heads (or rows of the batch) against
        # its kv heads, the positions whole (``kernels.ops.run_sharded``)
        return _ops.run_sharded(
            q, k, v, lambda ql, kl, vl, row0: _sdpa_block(ql, kl, vl, m))
    return _sdpa_block(q, k, v, m)


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig,
         kv_x: Optional[torch.Tensor] = None):
    """q from ``x``; k and v from ``kv_x`` where given (cross-attention's
    memory, taken as it is: not normalised), else from ``x``."""
    d = x.shape[-1]
    x = hints.tp_in(x, p["wq"], p["wk"], p["wv"])
    src = x if kv_x is None else hints.tp_in(kv_x, p["wk"], p["wv"])
    q = (x @ p["wq"].reshape(d, -1)).unflatten(-1, p["wq"].shape[-2:])
    k = (src @ p["wk"].reshape(d, -1)).unflatten(-1, p["wk"].shape[-2:])
    v = (src @ p["wv"].reshape(d, -1)).unflatten(-1, p["wv"].shape[-2:])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q, k, v = hints.heads(q, k, v)
    return (q, *hints.kv_gather(k, v))


def _proj_out(p: dict, attn: torch.Tensor, x: torch.Tensor,
              cross: bool = False) -> torch.Tensor:
    """``x + attn wo``; cross-attention scales ``attn wo`` by
    ``tanh(xattn_gate)`` first."""
    out = attn.flatten(-2) @ p["wo"].reshape(-1, p["wo"].shape[-1])
    if cross:
        out = out * torch.tanh(p["xattn_gate"]).to(out.dtype)
    return x + hints.seq(out)


# ------------------------------------------------------------- full-seq ops
def attn_train(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
               causal: bool = True, pos_offset: int = 0,
               kernel_mode: str = "auto") -> torch.Tensor:
    """Self-attention over a full sequence. x: [B, S, D]."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)
    pos = torch.arange(x.shape[-2], device=x.device) + pos_offset
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = _sdpa(q, k, v, causal=causal,
                window=cfg.sliding_window if causal else None,
                kernel_mode=kernel_mode)
    return _proj_out(p, out, x)


def xattn_train(p: dict, x: torch.Tensor, memory: torch.Tensor,
                cfg: ArchConfig, *, kernel_mode: str = "auto"
                ) -> torch.Tensor:
    """Gated cross-attention of x [B, S, D] to ``memory`` [B, S_mem, D]:
    no RoPE on either side, no mask, no window.  A full-length query goes
    to the flash kernel (``causal=False``), a single row (decode) to
    ``_sdpa_block`` with the zero mask, as the reference routes them."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, kv_x=memory)
    out = _sdpa(q, k, v, causal=False, kernel_mode=kernel_mode)
    return _proj_out(p, out, x, cross="xattn_gate" in p)


def xattn_decode(p: dict, x: torch.Tensor, memory: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """Cross-attention for decode: k and v are taken from the static memory
    again at every step (no cache, as the reference does)."""
    return xattn_train(p, x, memory, cfg)


# ------------------------------------------------------------------- cache
def init_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                    stacked: Optional[int], dtype=torch.bfloat16) -> dict:
    """KV cache spec. Sliding-window archs cache only the window (ring)."""
    hkv, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window \
        else max_len
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    shape = pre_s + (batch, length, hkv, dh)
    axes = pre_a + ("act_batch", "kv_seq", "kv_heads", None)
    return {"k": ParamSpec(shape, axes, dtype, "zeros"),
            "v": ParamSpec(shape, axes, dtype, "zeros")}


def attn_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict, *,
                 kernel_mode: str = "auto") -> tuple[torch.Tensor, dict]:
    """Full-sequence attention that also fills the cache (keys post-RoPE),
    in place."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)
    s = x.shape[-2]
    pos = torch.arange(s, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = _proj_out(p, _sdpa(q, k, v, causal=True, window=cfg.sliding_window,
                             kernel_mode=kernel_mode), x)
    clen = cache["k"].shape[-3]
    keep = min(s, clen)
    # ring placement: position p lives at slot p % clen (no-op when clen >= s)
    slots = slice(0, s) if clen >= s else torch.arange(
        s - keep, s, device=hints.index_device(cache["k"], x.device)) % clen
    hints.write(cache["k"], -3, slots,
                k[..., s - keep:, :, :].to(cache["k"].dtype))
    hints.write(cache["v"], -3, slots,
                v[..., s - keep:, :, :].to(cache["v"].dtype))
    return out, cache


def attn_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: [B, 1, D]; pos: the current position, a host
    int.  Writes the token's k and v into the cache in place.

    Sliding-window caches are rings indexed by pos % window; full caches
    write at pos.  Key invariant: cached keys already carry RoPE.
    """
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)
    pos_t = torch.full((1,), pos, device=x.device)
    q = apply_rope(q, pos_t, cfg.rope_theta)
    k = apply_rope(k, pos_t, cfg.rope_theta)
    clen = cache["k"].shape[-3]
    slot = pos % clen if cfg.sliding_window else pos
    hints.write(cache["k"], -3, slice(slot, slot + 1),
                k.to(cache["k"].dtype))
    hints.write(cache["v"], -3, slice(slot, slot + 1),
                v.to(cache["v"].dtype))
    kpos_abs = torch.arange(clen, device=x.device)
    if cfg.sliding_window:
        # ring: entry i holds the latest position congruent to i mod clen
        kpos_abs = torch.where(kpos_abs <= slot, pos - slot + kpos_abs,
                               pos - slot - clen + kpos_abs)
    valid = (kpos_abs >= 0) & (kpos_abs <= pos)
    if cfg.sliding_window:
        valid &= kpos_abs > pos - cfg.sliding_window
    bias = torch.where(valid, 0.0, NEG_INF)[None, :]  # [1(sq), clen]
    out = _proj_out(p, _sdpa(q, cache["k"], cache["v"], causal=False,
                             bias=bias), x)
    return out, cache
