"""The port's kernel wrappers applied to whole stacked models, and the GQA
flash attention (``flash_attention``, on ``kernels.flash_attention``:
batch and heads are its kernel's grid axes where the JAX package vmaps;
with its gradient when an input requires one).

Port of ``repro.kernels.ops``.  Weights are dicts of stacked leaves; the
leading ``mask.dim()`` axes are batch axes then the participant axis.
The kernels take the batch axes as a grid axis (where the JAX package
vmaps) and every leaf of an aggregate as it is, in one launch
(``hieavg_agg``, ``coef_agg``, ``coef_agg_pair``).  The tiny ``[..., n]``
coefficient vectors are computed here in PyTorch, with the recipes of
``repro.kernels.ops`` and ``repro.kernels.dispatch``.
"""
from __future__ import annotations

import torch

from repro_torch.core.hieavg import History, per_row

from .coef_agg import coef_agg_many, coef_agg_pair_many
from .hieavg_agg import hieavg_agg_many
from .flash_attention import FlashAttentionFn
from .flash_attention import flash_attention as _flash_attention
from .sgd_update import sgd_update_many


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0, mode: str = "auto"):
    """The GQA flash attention (``kernels.flash_attention``).  When an
    input requires a gradient (and grad mode is on) it goes through
    ``FlashAttentionFn``, whose backward is the backward kernels; else the
    forward alone, which writes no ``lse``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                      mode)
    return _flash_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, mode=mode)


def fused_mix_and_update(stacked_w: dict, mask: torch.Tensor,
                         history: History, part_weights: torch.Tensor,
                         gamma0, lam, normalize: bool = False, *,
                         mode: str = "auto") -> tuple[dict, History]:
    """``hieavg._mix_and_update`` (eq. 4/5) with the heavy mix and history
    update of every leaf in one ``hieavg_agg`` launch; ``gamma0``/``lam``
    host scalars or per-row tensors (``hieavg.per_row``)."""
    m = mask.to(torch.float32)
    gamma = per_row(gamma0, m) * torch.pow(per_row(lam, m),
                                           history.miss_count + 1.0)  # k'>=1
    coef = part_weights * (m + (1.0 - m) * gamma)
    if normalize:
        coef = coef / torch.clamp(coef.sum(-1, keepdim=True), min=1e-12)
    names = list(stacked_w)
    aggs, nprevs, ndmeans = hieavg_agg_many(
        [stacked_w[k] for k in names],
        [history.prev_w[k] for k in names],
        [history.delta_mean[k] for k in names],
        m, coef * m, coef * (1.0 - m), history.n_obs, mode=mode)
    aggs, nprevs, ndmeans = (dict(zip(names, x))
                             for x in (aggs, nprevs, ndmeans))
    return aggs, History(prev_w=nprevs, delta_mean=ndmeans,
                         n_obs=history.n_obs + m,
                         miss_count=(history.miss_count + 1.0) * (1.0 - m))


def fused_edge_aggregate_batched(stacked_w: dict, mask: torch.Tensor,
                                 history: History, valid: torch.Tensor,
                                 gamma0, lam, normalize: bool = False, *,
                                 mode: str = "auto") -> tuple[dict, History]:
    """Eq. (4) for all N edges (``[N, J, ...]`` leaves, ``[N, J]``
    mask/valid); part weights ``valid / max(J_e, 1)``, so padded slots add
    nothing."""
    v = valid.to(torch.float32)
    pw = v / torch.clamp(v.sum(-1, keepdim=True), min=1.0)
    return fused_mix_and_update(stacked_w, mask, history, pw, gamma0, lam,
                                normalize, mode=mode)


def fused_edge_aggregate(stacked_w: dict, mask: torch.Tensor,
                         history: History, *, gamma0: float = 0.9,
                         lam: float = 0.9, normalize: bool = False,
                         mode: str = "auto") -> tuple[dict, History]:
    """Eq. (4) for one edge (``[n, ...]`` leaves, ``[n]`` mask) with
    uniform ``1/n`` part weights: the reference's single-edge API, for
    direct callers and kernel benchmarks.  Returns (edge model, updated
    History)."""
    n = mask.shape[0]
    pw = torch.full((n,), 1.0 / n, dtype=torch.float32, device=mask.device)
    return fused_mix_and_update(stacked_w, mask, history, pw, gamma0, lam,
                                normalize, mode=mode)


def fused_coef_aggregate(stacked_w: dict, coef: torch.Tensor, *,
                         mode: str = "auto") -> dict:
    """``sum_n coef[..., n] * w[..., n, ...]`` per leaf (float32), every
    leaf in one ``coef_agg`` launch."""
    names = list(stacked_w)
    return dict(zip(names, coef_agg_many([stacked_w[k] for k in names],
                                         coef, mode=mode)))


def fused_coef_aggregate_pair(stacked_w: dict, aux: dict, ca: torch.Tensor,
                              cb: torch.Tensor, *, mode: str = "auto"
                              ) -> dict:
    """``sum_n ca[..., n] * w[..., n, ...] + cb[..., n] * aux[..., n, ...]``
    per leaf (float32), every leaf in one ``coef_agg_pair`` launch: the
    delayed-gradient mix."""
    names = list(stacked_w)
    return dict(zip(names, coef_agg_pair_many(
        [stacked_w[k] for k in names], [aux[k] for k in names], ca, cb,
        mode=mode)))


def fused_sgd_update(params: dict, grads: dict, scale, *,
                     mode: str = "auto") -> dict:
    """``w - scale * g`` per leaf, every leaf in one ``sgd_update`` launch;
    ``scale`` is a host float or a ``[rows]`` vector of per-row scales
    (``sgd_update_many``).  (Autograd may hand a leaf's gradient over as a
    strided view.)"""
    names = list(params)
    out = sgd_update_many([params[k] for k in names],
                          [grads[k].contiguous() for k in names], scale,
                          mode=mode)
    return dict(zip(names, out))

