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
def sgd_update_ref(w, g, scale):
    """``w - scale * g`` in float32, cast back to ``w``'s dtype, the
    product and the difference rounded apart; a scale of 0 is an exact
    identity.  ``scale``: a host float, or a ``[rows]`` tensor whose entry
    d scales row d of the ``[rows, ...]`` leaf."""
    if isinstance(scale, torch.Tensor):
        scale = scale.to(f32).reshape((-1,) + (1,) * (w.dim() - 1))
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


def _flash_mask(c0: int, n: int, skv: int, causal: bool, window,
                q_offset: int, device) -> torch.Tensor:
    """[n, skv]: which keys query rows ``c0 .. c0 + n - 1`` see."""
    kpos = torch.arange(skv, device=device)
    qpos = torch.arange(c0, c0 + n, device=device)[:, None] + q_offset
    ok = torch.ones((n, skv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return ok


def _heads(t: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, n, H, Dh] -> [B, Hkv, G * n, Dh] in float32, the query heads of
    kv head j at rows ``j``'s block, group-major."""
    b, n, h, dh = t.shape
    return t.to(f32).reshape(b, n, hkv, h // hkv, dh).permute(
        0, 2, 3, 1, 4).reshape(b, hkv, h // hkv * n, dh)


def _unheads(t: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of ``_heads``: [B, Hkv, G * n, Dh] -> [B, n, H, Dh]."""
    b, hkv, gn, dh = t.shape
    return t.view(b, hkv, gn // n, n, dh).permute(0, 3, 1, 2, 4).reshape(
        b, n, hkv * (gn // n), dh)


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None, q_offset: int = 0):
    """``softmax(q kᵀ / sqrt(Dh)) v`` over GQA heads: q [B, Sq, H, Dh],
    k/v [B, Skv, Hkv, Dh] -> (o [B, Sq, H, Dh] in ``v.dtype``, lse
    [B, H, Sq] float32).

    Query head h reads kv head ``h // (H // Hkv)``.  Query row i sits at
    absolute position ``q_offset + i``; ``causal`` keeps keys at or before
    it, ``window`` (None: no window) keys less than ``window`` positions
    behind it.  float32 math, in chunks of ``FLASH_Q_CHUNK`` query rows,
    out of place (autograd can run through it).  ``lse`` is each row's
    log-sum-exp of its scaled logits; a row that sees no key gives exactly
    0, as the Pallas kernel does (``repro.kernels.ref.flash_attention_ref``
    gives the mean of v there), and lse ``+inf``, so that ``exp(t - lse)``
    is 0 for every logit t of it.
    """
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    kt = k.to(f32).permute(0, 2, 3, 1)                  # [B, Hkv, Dh, Skv]
    vf = v.to(f32).permute(0, 2, 1, 3)                  # [B, Hkv, Skv, Dh]
    outs, lses = [], []
    for c0 in range(0, sq, FLASH_Q_CHUNK):
        qc = q[:, c0:c0 + FLASH_Q_CHUNK]
        n = qc.shape[1]
        logits = torch.matmul(_heads(qc, hkv), kt) / math.sqrt(dh)
        logits = logits.view(b, hkv, g, n, skv)
        ok = _flash_mask(c0, n, skv, causal, window, q_offset, q.device)
        logits = logits.masked_fill(~ok, -math.inf)
        m = logits.amax(-1, keepdim=True)
        m = torch.where(m == -math.inf, 0.0, m)          # rows with no key
        p = (logits - m).exp()
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.view(b, hkv, g * n, skv), vf).view(b, hkv, g, n, dh)
        o = o / torch.where(l == 0.0, 1.0, l)
        outs.append(_unheads(o.view(b, hkv, g * n, dh), n).to(v.dtype))
        seen = l != 0.0
        lse = torch.where(seen, m + torch.log(torch.where(seen, l, 1.0)),
                          math.inf)
        lses.append(lse.reshape(b, h, n))
    return torch.cat(outs, 1), torch.cat(lses, 2)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0):
    """The output of ``flash_attention_fwd_ref`` alone."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)[0]


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: Optional[int] = None, q_offset: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention_fwd_ref``'s output
    against ``do``, from its ``o`` and ``lse``, written out and chunked over
    query rows as the forward is (float32 math, each gradient in its
    input's dtype):

      delta = rowsum(do * o)
      P     = exp(qkᵀ / sqrt(Dh) - lse) where the masks keep the pair, else 0
      dv    = sum_g Pᵀ do
      dS    = P * (do vᵀ - delta)
      dq    = dS k / sqrt(Dh)
      dk    = sum_g dSᵀ q / sqrt(Dh)

    The sum over the G query heads of a kv head is the matmul over the
    group-major rows.  delta is summed in float64 and rounded once, as the
    kernel does.  A row that sees no key has P = 0: its dq is 0 and it
    adds nothing to dk, dv."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(dh)
    kf = k.to(f32).permute(0, 2, 1, 3)                  # [B, Hkv, Skv, Dh]
    vf = v.to(f32).permute(0, 2, 1, 3)
    delta = (do.double() * o.double()).sum(-1).to(f32)  # [B, Sq, H]
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    for c0 in range(0, sq, FLASH_Q_CHUNK):
        qc = _heads(q[:, c0:c0 + FLASH_Q_CHUNK], hkv)   # [B, Hkv, G n, Dh]
        n = qc.shape[2] // g
        doc = _heads(do[:, c0:c0 + n], hkv)
        dc = delta[:, c0:c0 + n].reshape(b, n, hkv, g).permute(0, 2, 3, 1)
        lc = lse[:, :, c0:c0 + n].reshape(b, hkv, g, n)
        t = (torch.matmul(qc, kf.transpose(2, 3)) / math.sqrt(dh)).view(
            b, hkv, g, n, skv)
        ok = _flash_mask(c0, n, skv, causal, window, q_offset, q.device)
        p = torch.where(ok, torch.exp(t - lc[..., None]), 0.0)
        dp = torch.matmul(doc, vf.transpose(2, 3)).view(b, hkv, g, n, skv)
        ds = (p * (dp - dc[..., None])).view(b, hkv, g * n, skv)
        p = p.view(b, hkv, g * n, skv)
        dv += torch.matmul(p.transpose(2, 3), doc)
        dk += torch.matmul(ds.transpose(2, 3), qc) * scale
        dqs.append(_unheads(torch.matmul(ds, kf) * scale, n).to(q.dtype))
    return (torch.cat(dqs, 1), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
