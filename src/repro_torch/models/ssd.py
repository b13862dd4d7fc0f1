"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

Port of ``repro.models.ssd``.  Block: in_proj -> [z | x | B | C | dt],
causal conv (with SiLU) over (x, B, C), the SSD core, gated RMSNorm,
out_proj.  The core is the chunked algorithm: a quadratic attention-like
term inside each chunk and a linear recurrence of the chunks' states.
Decode is the one-step recurrence on a per-head state ``h [B, H, P, N]``.

The reference's four-operand einsums are written as explicit products
(``C Bᵀ``, then ``∘ L``, then ``@ x``), float32 throughout, and its
associative scan over the chunks is a loop over them: the same sums in
another order.  ``_segsum`` keeps the reference's cumsum differences and
its order, the mask applied before the exp (masked entries are -inf, whose
exp and gradient are 0; the upper triangle's differences never reach
``exp``, where they would overflow).  The port writes the caches in place
(``copy_`` into the cache's tensors); ``ssd_prefill`` starts from a zero
state and a zero conv window whatever the cache holds, as the reference's
does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import hints
from .config import ArchConfig
from .layers import norm_spec, rms_norm
from .spec import ParamSpec

f32 = torch.float32


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.d_state, s.head_dim


def ssd_specs(cfg: ArchConfig, stacked: Optional[int]) -> dict:
    s = cfg.ssm
    d_inner, nh, n, _ = _dims(cfg)
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    d = cfg.d_model
    return {
        "w_in": ParamSpec(pre_s + (d, 2 * d_inner + 2 * n + nh),
                          pre_a + ("embed", "mlp")),
        "conv_w": ParamSpec(pre_s + (s.d_conv, d_inner + 2 * n),
                            pre_a + (None, "mlp")),
        "a_log": ParamSpec(pre_s + (nh,), pre_a + (None,), init="ones"),
        "dt_bias": ParamSpec(pre_s + (nh,), pre_a + (None,), init="zeros"),
        "d_skip": ParamSpec(pre_s + (nh,), pre_a + (None,), init="ones"),
        "out_norm": norm_spec(d_inner, pre_a, pre_s),
        "w_out": ParamSpec(pre_s + (d_inner, d), pre_a + ("mlp", "embed")),
        "norm": norm_spec(d, pre_a, pre_s),
    }


def _split_proj(p: dict, h: torch.Tensor, cfg: ArchConfig):
    """z, x, B, C, dt of the input projection."""
    d_inner, nh, n, _ = _dims(cfg)
    return torch.split(h @ p["w_in"], [d_inner, d_inner, n, n, nh], dim=-1)


def _conv(p: dict, u: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Causal depthwise conv over time, then SiLU. u: [B, S, W]; state
    [B, d_conv - 1, W] (zeros where None) -> (out, the new state)."""
    k = p["conv_w"].shape[0]
    pad = state if state is not None else u.new_zeros(
        u.shape[:-2] + (k - 1, u.shape[-1]))
    full = torch.cat([pad, u], dim=-2)
    out = sum(full[..., i:i + u.shape[-2], :] * p["conv_w"][i]
              for i in range(k))
    return F.silu(out), full[..., -(k - 1):, :]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., q, h] -> [..., h, q, q] with S[i, j] = sum_{j<k<=i} a_k
    (lower triangle; -inf above it)."""
    q = a.shape[-2]
    cum = torch.cumsum(a.movedim(-1, -2), dim=-1)              # [..., h, q]
    diff = cum[..., :, None] - cum[..., None, :]               # [..., h, q, q]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_core(x: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. x: [b, s, h, p] (dt-scaled), a_log: [b, s, h]
    (negative), B, C: [b, s, n] shared across heads -> (y [b, s, h, p],
    the final state [b, h, p, n]), float32."""
    b, s, nh, pd = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (a_log, B, C))
    nc = x.shape[1] // chunk
    xf = x.reshape(b, nc, chunk, nh, pd).to(f32)
    ac = a_log.reshape(b, nc, chunk, nh).to(f32)
    Bc = B.reshape(b, nc, chunk, n).to(f32)
    Cc = C.reshape(b, nc, chunk, n).to(f32)

    # inside each chunk (quadratic, attention-like): (C Bᵀ ∘ L) x per head
    L = torch.exp(_segsum(ac))                                 # [b,c,h,q,q]
    scores = (Cc @ Bc.transpose(-1, -2))[:, :, None] * L       # [b,c,h,q,k]
    y_diag = (scores @ xf.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # each chunk's final state from its own inputs
    cum = torch.cumsum(ac, dim=2)                              # [b,c,q,h]
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)          # [b,c,q,h]
    states = (xf * decay_states[..., None]).permute(0, 1, 3, 4, 2) \
        @ Bc[:, :, None]                                       # [b,c,h,p,n]

    # the recurrence over the chunks, from h0: the state before each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # [b,c,h]
    h = torch.zeros((b, nh, pd, n), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    before = []
    for c in range(nc):
        before.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(before, dim=1)                        # [b,c,h,p,n]

    y_off = (Cc[:, :, None] @ h_prev.transpose(-1, -2)).permute(
        0, 1, 3, 2, 4) * torch.exp(cum)[..., None]             # [b,c,q,h,p]
    y = (y_diag + y_off).reshape(b, nc * chunk, nh, pd)[:, :s]
    return y, h


def ssd_train(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return _ssd_forward(p, x, cfg, conv_state=None, h0=None)[0]


def ssd_cache_spec(cfg: ArchConfig, batch: int, stacked: Optional[int],
                   dtype=f32) -> dict:
    """The recurrent state ``h`` [B, H, P, N] and the conv window
    [B, d_conv - 1, conv_dim], float32 unless asked."""
    d_inner, nh, n, pd = _dims(cfg)
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    return {
        "h": ParamSpec(pre_s + (batch, nh, pd, n),
                       pre_a + ("act_batch", None, None, None), dtype,
                       "zeros"),
        "conv": ParamSpec(pre_s + (batch, cfg.ssm.d_conv - 1,
                                   d_inner + 2 * n),
                          pre_a + ("act_batch", None, None), dtype, "zeros"),
    }


def _gated_out(p: dict, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
               cfg: ArchConfig) -> torch.Tensor:
    """``x + rms_norm(y silu(z)) w_out``, y cast to x's dtype first."""
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["out_norm"], cfg.norm_eps)
    return x + hints.seq(y @ p["w_out"])


def _ssd_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, conv_state, h0):
    """The block over a full sequence -> (out, final state, conv window)."""
    d_inner, nh, n, pd = _dims(cfg)
    z, xs, B, C, dt = _split_proj(
        p, hints.whole_seq(rms_norm(x, p["norm"], cfg.norm_eps)), cfg)
    conv_out, new_conv = _conv(p, torch.cat([xs, B, C], dim=-1), conv_state)
    xs, B, C = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                 # [b,s,h]
    a_log = dt * -torch.exp(p["a_log"].to(f32))                # [b,s,h]
    xh = xs.unflatten(-1, (nh, pd))
    xin, chunk = xh.to(f32) * dt[..., None], cfg.ssm.chunk
    # independent per head given B and C: on each rank's heads on a mesh
    heads = ((xin, 2), (a_log, 2)) + (() if h0 is None else ((h0, 1),))
    y, h_final = hints.split_heads(
        lambda xs_, a_, *h_b_c: ssd_core(xs_, a_, *h_b_c[-2:], chunk,
                                         *h_b_c[:-2]),
        xin, heads, (B, C), (2, 1))
    y = y + p["d_skip"][:, None] * xh.to(f32)
    return (_gated_out(p, x, hints.flat_heads(y, nh), z, cfg), h_final,
            new_conv)


def ssd_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict
                ) -> tuple[torch.Tensor, dict]:
    """The block over the prompt from a zero state and a zero conv window
    (whatever the cache holds, as the reference); the final state and
    window are written into the cache in place."""
    out, h, conv = _ssd_forward(p, x, cfg, conv_state=None, h0=None)
    hints.assign(cache["h"], h)
    hints.assign(cache["conv"], conv)
    return out, cache


def ssd_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict
               ) -> tuple[torch.Tensor, dict]:
    """One-step recurrence. x: [B, 1, D]; the state h [B, H, P, N] and the
    conv window updated in place."""
    d_inner, nh, n, pd = _dims(cfg)
    z, xs, B, C, dt = _split_proj(p, rms_norm(x, p["norm"], cfg.norm_eps),
                                  cfg)
    conv_in = torch.cat([xs, B, C], dim=-1)
    conv_out, new_conv = _conv(p, conv_in, cache["conv"].to(conv_in.dtype))
    xs, B, C = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt[..., 0, :].to(f32) + p["dt_bias"])      # [b,h]
    decay = torch.exp(dt * -torch.exp(p["a_log"].to(f32)))     # [b,h]
    xh = xs[..., 0, :].reshape(x.shape[0], nh, pd).to(f32)
    Bf, Cf = B[..., 0, :].to(f32), C[..., 0, :].to(f32)        # [b,n]
    h_new = decay[..., None, None] * cache["h"].to(f32) \
        + (dt[..., None] * xh)[..., None] * Bf[:, None, None, :]
    y = (h_new @ Cf[:, None, :, None])[..., 0] + p["d_skip"][:, None] * xh
    out = _gated_out(p, x, y.reshape(x.shape[0], 1, d_inner), z, cfg)
    hints.assign(cache["h"], h_new)
    hints.assign(cache["conv"], new_conv)
    return out, cache
