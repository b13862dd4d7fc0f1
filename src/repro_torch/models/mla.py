"""Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3).

Port of ``repro.models.mla``.  K and V are compressed into a latent
``c_kv`` of rank ``kv_lora_rank`` plus one RoPE key of
``qk_rope_head_dim`` shared by the heads: the decode cache holds only
``c_kv [B, S, kv_lora]`` and ``k_rope [B, S, rope]``.

A full sequence (``mla_train``, ``mla_prefill``) expands the latent to
per-head keys ``k_nope || k_rope`` and values, zero-pads the values to
the key width ``nope + rope`` and attends through ``attention._sdpa``:
the flash kernel at head dim ``nope + rope`` (96 for MiniCPM3, 192 for
DeepSeek-V2-Lite), or its plain version per ``kernel_mode``; the padded
columns of the output are 0 and are sliced off.  Decode
(``mla_decode``) absorbs ``W_uk`` into the query and ``W_uv`` into the
output, so attention runs in float32 on the compressed cache, one query
row, plain PyTorch as in the reference.  The cache is written in place.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import hints
from .attention import NEG_INF, _sdpa, apply_rope
from .config import ArchConfig
from .layers import norm_spec, rms_norm
from .spec import ParamSpec

f32 = torch.float32


def mla_specs(cfg: ArchConfig, stacked: Optional[int]) -> dict:
    """The latent KV projections and norms, and q: a direct ``wq`` or,
    with ``q_lora_rank``, a low-rank ``w_dq`` / ``q_norm`` / ``w_uq``."""
    m = cfg.mla
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    out = {
        "w_dkv": ParamSpec(pre_s + (d, m.kv_lora_rank),
                           pre_a + ("embed", None)),
        "kv_norm": norm_spec(m.kv_lora_rank, pre_a, pre_s),
        "w_kr": ParamSpec(pre_s + (d, m.qk_rope_head_dim),
                          pre_a + ("embed", None)),
        "w_uk": ParamSpec(pre_s + (m.kv_lora_rank, h, m.qk_nope_head_dim),
                          pre_a + (None, "heads", None)),
        "w_uv": ParamSpec(pre_s + (m.kv_lora_rank, h, m.v_head_dim),
                          pre_a + (None, "heads", None)),
        "wo": ParamSpec(pre_s + (h, m.v_head_dim, d),
                        pre_a + ("heads", None, "embed")),
        "norm": norm_spec(d, pre_a, pre_s),
    }
    if m.q_lora_rank:
        out["w_dq"] = ParamSpec(pre_s + (d, m.q_lora_rank),
                                pre_a + ("embed", None))
        out["q_norm"] = norm_spec(m.q_lora_rank, pre_a, pre_s)
        out["w_uq"] = ParamSpec(pre_s + (m.q_lora_rank, h, qk),
                                pre_a + (None, "heads", None))
    else:
        out["wq"] = ParamSpec(pre_s + (d, h, qk),
                              pre_a + ("embed", "heads", None))
    return out


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...r,rhk->...hk", x, w)`` as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _q_proj(p: dict, h: torch.Tensor, cfg: ArchConfig):
    """(q_nope, q_rope) [..., H, nope] and [..., H, rope]."""
    m = cfg.mla
    if m.q_lora_rank:
        ql = rms_norm(h @ p["w_dq"], p["q_norm"], cfg.norm_eps)
        q = _heads(ql, p["w_uq"])
    else:
        q = _heads(h, p["wq"])
    return q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)


def _latent(p: dict, h: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor):
    """(c_kv [..., S, kv_lora] normalised, k_rope [..., S, rope] after
    RoPE at ``pos``): what the cache holds."""
    c_kv = rms_norm(h @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope((h @ p["w_kr"])[..., None, :], pos,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _qkv(p: dict, h: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor):
    """A full sequence's attention operands, [B, S, H, nope + rope] each:
    q, k (``k_nope || k_rope``, the RoPE key shared by the heads) and v
    zero-padded to that width; and the latents the cache holds (c_kv,
    k_rope)."""
    m = cfg.mla
    q_nope, q_rope = _q_proj(p, h, cfg)
    c_kv, k_rope = _latent(p, h, cfg, pos)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    k_nope = _heads(c_kv, p["w_uk"])                         # [B,S,H,nope]
    v = _heads(c_kv, p["w_uv"])
    k = hints.per_head(_with_rope, k_nope, k_rope)
    q = torch.cat([q_nope, q_rope], dim=-1)
    pad = m.qk_nope_head_dim + m.qk_rope_head_dim - m.v_head_dim
    if pad:
        v = hints.along_last(lambda t: F.pad(t, (0, pad)), v)
    return q, k, v, c_kv, k_rope


def _with_rope(k_nope: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """``k_nope || k_rope``: the RoPE key [..., S, rope] shared by the
    heads of k_nope [..., S, H, nope]."""
    return torch.cat([k_nope, k_rope[..., None, :].expand(
        *k_nope.shape[:-1], k_rope.shape[-1])], dim=-1)


def _mla_full(p: dict, x: torch.Tensor, cfg: ArchConfig, kernel_mode: str):
    """Full-sequence causal MLA: (x + out, c_kv, k_rope)."""
    h = hints.whole_seq(rms_norm(x, p["norm"], cfg.norm_eps))
    pos = torch.arange(x.shape[-2], device=x.device)
    q, k, v, c_kv, k_rope = _qkv(p, h, cfg, pos)
    attn = _sdpa(q, k, v, causal=True, kernel_mode=kernel_mode)
    attn = attn[..., :cfg.mla.v_head_dim]
    out = attn.to(x.dtype).flatten(-2) @ p["wo"].reshape(-1, x.shape[-1])
    return x + hints.seq(out), c_kv, k_rope


def mla_train(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
              kernel_mode: str = "auto") -> torch.Tensor:
    """Full-sequence causal MLA. x: [B, S, D]."""
    return _mla_full(p, x, cfg, kernel_mode)[0]


def mla_cache_spec(cfg: ArchConfig, batch: int, max_len: int,
                   stacked: Optional[int], dtype=torch.bfloat16) -> dict:
    """The compressed cache: ``c_kv [B, S, kv_lora]`` and ``k_rope [B, S,
    rope]`` (keys after RoPE)."""
    m = cfg.mla
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    axes = pre_a + ("act_batch", "kv_seq", None)
    return {"c_kv": ParamSpec(pre_s + (batch, max_len, m.kv_lora_rank),
                              axes, dtype, "zeros"),
            "k_rope": ParamSpec(pre_s + (batch, max_len, m.qk_rope_head_dim),
                                axes, dtype, "zeros")}


def mla_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict, *,
                kernel_mode: str = "auto") -> tuple[torch.Tensor, dict]:
    """``mla_train``, and the cache's first ``keep = min(S, cache length)``
    slots written, in place, with the last ``keep`` positions' latents."""
    out, c_kv, k_rope = _mla_full(p, x, cfg, kernel_mode)
    keep = min(x.shape[-2], cache["c_kv"].shape[-2])
    hints.write(cache["c_kv"], -2, slice(0, keep),
                c_kv[..., -keep:, :].to(cache["c_kv"].dtype))
    hints.write(cache["k_rope"], -2, slice(0, keep),
                k_rope[..., -keep:, :].to(cache["k_rope"].dtype))
    return out, cache


def mla_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
               pos: int) -> tuple[torch.Tensor, dict]:
    """Absorbed one-token decode on the compressed cache. x: [B, 1, D];
    pos the current position, a host int; the token's latents are written
    into the cache in place.  Logits ``(q_nope W_uk) c_kv + q_rope k_rope``
    scaled by ``1/sqrt(nope + rope)``, keys past ``pos`` masked, values
    mixed in latent space and expanded through ``W_uv``, all float32."""
    m = cfg.mla
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q_nope, q_rope = _q_proj(p, h, cfg)                     # [B,1,H,*]
    pos_t = torch.full((1,), pos, device=x.device)
    q_rope = apply_rope(q_rope, pos_t, cfg.rope_theta)
    c_new, kr_new = _latent(p, h, cfg, pos_t)
    ck, ckr = cache["c_kv"], cache["k_rope"]
    hints.write(ck, -2, slice(pos, pos + 1), c_new.to(ck.dtype))
    hints.write(ckr, -2, slice(pos, pos + 1), kr_new.to(ckr.dtype))
    # absorb W_uk into q: [B,1,H,nope] x [r,H,nope] -> [B,1,H,r]
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope.to(f32),
                         p["w_uk"].to(f32))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    ckf = ck.to(f32)
    logits = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckf)
              + torch.einsum("bqhk,bsk->bhqs", q_rope.to(f32),
                             ckr.to(f32))) * scale
    valid = torch.arange(ck.shape[-2], device=x.device) <= pos
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    # value mixing in latent space, then the expansion through W_uv
    lat = torch.einsum("bhqs,bsr->bqhr", probs, ckf)
    attn = hints.reduced(torch.einsum("bqhr,rhk->bqhk", lat,
                                      p["w_uv"].to(f32)))
    out = attn.to(x.dtype).flatten(-2) @ p["wo"].reshape(-1, x.shape[-1])
    return x + hints.seq(out), cache
