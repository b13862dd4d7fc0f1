"""The plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in ordinary tensor
operations, with the layouts of ``repro.kernels.ref``.  The kernel
wrappers run them for CPU tensors and under ``kernel_mode="torch"``; the
CPU tests hold them against the JAX kernels, and ``chip_smoke.py`` holds
each CUDA kernel against its plain version on the card.

Leading batch axes are allowed where the engine has them: ``[..., n, L]``
operands with ``[..., n]`` coefficient vectors.  Attention takes the GQA
layout of ``repro.models.attention``: ``[B, S, H, Dh]``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.hieavg import to_history_dtype

f32 = torch.float32


# ------------------------------------------------------------- hieavg_agg
def hieavg_agg_ref(w, prev, dmean, mask, coef_present, coef_est, n_obs):
    """HieAvg mix + history update on ``[..., n, L]`` leaves.

      agg       = sum_n coef_present*w + coef_est*(prev + dmean)
      new_prev  = m*w + (1-m)*(prev + dmean)
      new_dmean = m*((dmean*n_obs + (w - prev)) / (n_obs+1)) + (1-m)*dmean

    Returns (agg [..., L], new_prev, new_dmean); float32 math, outputs in
    their operands' dtypes (a narrow history dtype cast as
    ``core.hieavg.to_history_dtype`` casts it).
    """
    wf, pf, df = w.to(f32), prev.to(f32), dmean.to(f32)
    m = mask.to(f32)[..., None]
    cp = coef_present.to(f32)[..., None]
    ce = coef_est.to(f32)[..., None]
    nb = n_obs.to(f32)[..., None]
    est = pf + df
    agg = (cp * wf + ce * est).sum(-2)
    new_prev = m * wf + (1.0 - m) * est
    new_dmean = m * ((df * nb + (wf - pf)) / (nb + 1.0)) + (1.0 - m) * df
    return (agg.to(w.dtype), to_history_dtype(new_prev, prev.dtype),
            to_history_dtype(new_dmean, dmean.dtype))


# -------------------------------------------------------------- sgd_update
def sgd_update_ref(w, g, scale: float):
    """``w - scale * g`` in float32, cast back to ``w``'s dtype; a scale of
    0 is an exact identity."""
    return (w.to(f32) - scale * g.to(f32)).to(w.dtype)


# ------------------------------------------------------- conv3x3_bias_relu
def im2col3x3(x):
    """[..., H, W, C] -> [..., H, W, 9C] SAME-padded 3x3 patches, (i, j, c)
    channel order (``w.reshape(9*Cin, Cout)`` rows)."""
    h, wd = x.shape[-3], x.shape[-2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[..., i:i + h, j:j + wd, :]
                      for i in range(3) for j in range(3)], dim=-1)


def conv3x3_fwd_ref(x, w, b):
    """``relu(conv3x3_same(x, w) + b)`` per device: x [D, ..., H, W, Cin],
    w [D, 3, 3, Cin, Cout], b [D, Cout]; im2col + ``bmm`` in float32."""
    D, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    cols = im2col3x3(x).reshape(D, -1, 9 * cin)
    y = torch.relu(torch.bmm(cols, w.reshape(D, 9 * cin, cout))
                   + b[:, None, :])
    return y.reshape(x.shape[:-1] + (cout,))


def conv3x3_bwd_ref(x, w, y, dy, need_dx: bool = True):
    """The backward of ``conv3x3_fwd_ref`` from its output ``y``:
    dz = dy*(y > 0); returns (dx or None, dW [D, 3, 3, Cin, Cout],
    db [D, Cout]).  dx is col2im of ``dcols = dz wᵀ`` written out: nine
    shifted adds into a padded buffer, whose border is then dropped."""
    D, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    h, wd = x.shape[-3], x.shape[-2]
    dz = (dy * (y > 0)).reshape(D, -1, cout)
    cols = im2col3x3(x).reshape(D, -1, 9 * cin)
    dw = torch.bmm(cols.transpose(1, 2), dz).reshape(w.shape)
    db = dz.sum(1)
    if not need_dx:
        return None, dw, db
    dcols = torch.bmm(dz, w.reshape(D, 9 * cin, cout).transpose(1, 2))
    dcols = dcols.reshape(x.shape[:-1] + (3, 3, cin))
    dxp = x.new_zeros(x.shape[:-3] + (h + 2, wd + 2, cin))
    for i in range(3):
        for j in range(3):
            dxp[..., i:i + h, j:j + wd, :] += dcols[..., i, j, :]
    return dxp[..., 1:h + 1, 1:wd + 1, :].contiguous(), dw, db


# ---------------------------------------------------------------- eval_head
def eval_head_ref(feats, wmat, bias, labels):
    """Count of rows where ``argmax(feats @ wmat + bias)`` (first maximum
    wins) equals the label; a 0-dim int64 tensor on ``feats``' device."""
    logits = feats.to(f32) @ wmat.to(f32) + bias.to(f32)
    pred = torch.argmax(logits, dim=-1)
    return (pred == labels.to(pred.dtype)).sum()


# ----------------------------------------------------------------- coef_agg
def coef_agg_ref(w, coef):
    """``sum_n coef[..., n] * w[..., n, L]`` in float32; a zero coefficient
    adds nothing."""
    return (coef.to(f32)[..., None] * w.to(f32)).sum(-2)


def coef_agg_pair_ref(w, aux, ca, cb):
    """``sum_n ca[..., n] * w[..., n, L] + cb[..., n] * aux[..., n, L]`` in
    float32 (the delayed-gradient mix); a zero coefficient adds nothing."""
    return (ca.to(f32)[..., None] * w.to(f32)
            + cb.to(f32)[..., None] * aux.to(f32)).sum(-2)


# --------------------------------------------------------- flash attention
#: query rows per step of ``flash_attention_ref``: ``[B, H, 512, Skv]``
#: float32 logits are live at once, never ``[B, H, Sq, Skv]``
FLASH_Q_CHUNK = 512


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0):
    """``softmax(q kᵀ / sqrt(Dh)) v`` over GQA heads: q [B, Sq, H, Dh],
    k/v [B, Skv, Hkv, Dh] -> [B, Sq, H, Dh] in ``v.dtype``.

    Query head h reads kv head ``h // (H // Hkv)``.  Query row i sits at
    absolute position ``q_offset + i``; ``causal`` keeps keys at or before
    it, ``window`` (None: no window) keys less than ``window`` positions
    behind it.  float32 math, in chunks of ``FLASH_Q_CHUNK`` query rows.
    A row that sees no key gives exactly 0, as the Pallas kernel does
    (``repro.kernels.ref.flash_attention_ref`` gives the mean of v there).
    """
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kt = k.to(f32).permute(0, 2, 3, 1)                  # [B, Hkv, Dh, Skv]
    vf = v.to(f32).permute(0, 2, 1, 3)                  # [B, Hkv, Skv, Dh]
    kpos = torch.arange(skv, device=q.device)
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for c0 in range(0, sq, FLASH_Q_CHUNK):
        qc = q[:, c0:c0 + FLASH_Q_CHUNK].to(f32)
        n = qc.shape[1]
        qc = qc.reshape(b, n, hkv, g, dh).permute(0, 2, 3, 1, 4)
        logits = torch.matmul(qc.reshape(b, hkv, g * n, dh), kt)
        logits = logits.div_(math.sqrt(dh)).view(b, hkv, g, n, skv)
        qpos = torch.arange(c0, c0 + n, device=q.device)[:, None] + q_offset
        ok = torch.ones((n, skv), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        logits.masked_fill_(~ok, -math.inf)
        m = logits.amax(-1, keepdim=True)
        m = torch.where(m == -math.inf, 0.0, m)          # rows with no key
        p = logits.sub_(m).exp_()
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.view(b, hkv, g * n, skv), vf).view(b, hkv, g, n, dh)
        o = o / torch.where(l == 0.0, 1.0, l)
        out[:, c0:c0 + n] = o.permute(0, 3, 1, 2, 4).reshape(
            b, n, h, dh).to(v.dtype)
    return out
