"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Port of ``repro.models.rglru``.  Block = temporal conv1d (width 4, no
activation) -> gated linear recurrence:

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

with a GELU gate branch (tanh form: ``jax.nn.gelu``'s default) and an
output projection; the residual is added here.  Train and prefill run the
recurrence as ``linear_scan``; decode is the one-step update.  The port
writes the caches in place; ``rglru_prefill`` starts the recurrence from
the cached ``h`` but the conv from a zero window, as the reference's does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import hints
from .config import ArchConfig
from .layers import norm_spec, rms_norm
from .spec import ParamSpec

f32 = torch.float32

#: the scan's chunk: a doubling scan inside each chunk, a carry across them
SCAN_CHUNK = 256


def _width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_specs(cfg: ArchConfig, stacked: Optional[int]) -> dict:
    w, d = _width(cfg), cfg.d_model
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    return {
        "w_in": ParamSpec(pre_s + (d, w), pre_a + ("embed", "mlp")),
        "w_gate": ParamSpec(pre_s + (d, w), pre_a + ("embed", "mlp")),
        "conv_w": ParamSpec(pre_s + (cfg.rglru.d_conv, w),
                            pre_a + (None, "mlp")),
        "w_a": ParamSpec(pre_s + (w, w), pre_a + ("mlp", None)),
        "w_i": ParamSpec(pre_s + (w, w), pre_a + ("mlp", None)),
        "lam": ParamSpec(pre_s + (w,), pre_a + (None,), init="ones"),
        "w_out": ParamSpec(pre_s + (w, d), pre_a + ("mlp", "embed")),
        "norm": norm_spec(d, pre_a, pre_s),
    }


def _gates(p: dict, u: torch.Tensor, cfg: ArchConfig):
    """a_t and the gated input of the recurrence, float32."""
    rec_gate = torch.sigmoid(u @ p["w_a"])
    in_gate = torch.sigmoid(u @ p["w_i"])
    log_a = -cfg.rglru.c_constant * F.softplus(p["lam"]) * rec_gate.to(f32)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (in_gate * u).to(f32)
    return torch.exp(log_a), gated_x


def _conv(p: dict, u: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Causal depthwise conv over time. u: [B, S, W]; state [B, d_conv - 1,
    W] (zeros where None) -> (out, the new state)."""
    k = p["conv_w"].shape[0]
    pad = state if state is not None else u.new_zeros(
        u.shape[:-2] + (k - 1, u.shape[-1]))
    full = torch.cat([pad, u], dim=-2)
    out = sum(full[..., i:i + u.shape[-2], :] * p["conv_w"][i]
              for i in range(k))
    return out, full[..., -(k - 1):, :]


def linear_scan(a: torch.Tensor, gx: torch.Tensor, h0=None,
                chunk: int = SCAN_CHUNK):
    """h_t = a_t h_{t-1} + gx_t along axis -2: a, gx [B, S, W] float32 ->
    (h [B, S, W], h_final [B, W]).

    The reference's algebra in log depth: padded with identity steps (a 1,
    gx 0) to whole chunks, a doubling (Hillis-Steele) scan of the pairs
    (A, H) inside every chunk at once (log2(chunk) steps of whole-tensor
    products), then the carry from chunk to chunk on [B, W] slices, then
    ``H + A h_before`` over the whole sequence.  It only multiplies the a's,
    so their products may underflow to 0 harmlessly (``exp(cumsum(log a))``
    divided out would not)."""
    b, s, w = a.shape
    if h0 is None:
        h0 = torch.zeros((b, w), dtype=f32, device=a.device)
    pad = (-s) % chunk
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        gx = F.pad(gx, (0, 0, 0, pad))
    nc = a.shape[1] // chunk
    A, H = a.reshape(b, nc, chunk, w), gx.reshape(b, nc, chunk, w)
    d = 1
    while d < chunk:      # step i -> combine(step i - d, step i)
        H = torch.cat([H[:, :, :d], H[:, :, :-d] * A[:, :, d:]
                       + H[:, :, d:]], dim=2)
        A = torch.cat([A[:, :, :d], A[:, :, :-d] * A[:, :, d:]], dim=2)
        d *= 2
    before = [h0.to(f32)]
    for c in range(nc - 1):
        before.append(H[:, c, -1] + A[:, c, -1] * before[-1])
    hs = H + A * torch.stack(before, dim=1)[:, :, None]
    return hs.reshape(b, nc * chunk, w)[:, :s], hs[:, -1, -1]


def _branches(p: dict, x: torch.Tensor, cfg: ArchConfig, conv_state=None):
    """(a, gx, the GELU gate, the new conv window) of the block's input."""
    h = hints.whole_seq(rms_norm(x, p["norm"], cfg.norm_eps))
    gate = F.gelu(h @ p["w_gate"], approximate="tanh")
    u, conv = _conv(p, h @ p["w_in"], conv_state)
    a, gx = _gates(p, u, cfg)
    return a, gx, gate, conv


def _out(p: dict, x: torch.Tensor, h: torch.Tensor, gate: torch.Tensor
         ) -> torch.Tensor:
    return x + hints.seq((h.to(x.dtype) * gate) @ p["w_out"])


def rglru_train(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The block over a full sequence. x: [B, S, D].  Under autograd the
    scan runs under ``torch.utils.checkpoint``: its doubling steps would
    keep 2 log2(SCAN_CHUNK) tensors of [B, S, W] float32 for the backward
    (4.3 GB a layer at recurrentgemma's 2 x 8192 x 4096), so it keeps its
    inputs and runs again before its gradient."""
    a, gx, gate, _ = _branches(p, x, cfg)
    if torch.is_grad_enabled() and (a.requires_grad or gx.requires_grad):
        h = checkpoint(hints.per_channel, linear_scan, a, gx, None,
                       use_reentrant=False)[0]
    else:
        h = hints.per_channel(linear_scan, a, gx, None)[0]
    return _out(p, x, h, gate)


def rglru_cache_spec(cfg: ArchConfig, batch: int, stacked: Optional[int],
                     dtype=f32) -> dict:
    """The recurrent state ``h`` [B, W] and the conv window [B, d_conv - 1,
    W], float32 unless asked."""
    w = _width(cfg)
    pre_s = (stacked,) if stacked else ()
    pre_a = ("layers",) if stacked else ()
    return {"h": ParamSpec(pre_s + (batch, w), pre_a + ("act_batch", "mlp"),
                           dtype, "zeros"),
            "conv": ParamSpec(pre_s + (batch, cfg.rglru.d_conv - 1, w),
                              pre_a + ("act_batch", None, "mlp"), dtype,
                              "zeros")}


def rglru_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict
                  ) -> tuple[torch.Tensor, dict]:
    """The block over the prompt: the recurrence from the cached ``h``, the
    conv from a zero window (as the reference); the final state and window
    written into the cache in place."""
    a, gx, gate, conv = _branches(p, x, cfg)
    h_s, h_fin = hints.per_channel(linear_scan, a, gx, cache["h"].to(f32))
    out = _out(p, x, h_s, gate)
    hints.assign(cache["h"], h_fin)
    hints.assign(cache["conv"], conv)
    return out, cache


def rglru_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict
                 ) -> tuple[torch.Tensor, dict]:
    """One-step recurrence. x: [B, 1, D]; the state and the conv window
    updated in place."""
    a, gx, gate, conv = _branches(p, x, cfg, cache["conv"].to(x.dtype))
    h_new = a[..., 0, :] * cache["h"].to(f32) + gx[..., 0, :]
    out = _out(p, x, h_new[..., None, :], gate)
    hints.assign(cache["h"], h_new)
    hints.assign(cache["conv"], conv)
    return out, cache
