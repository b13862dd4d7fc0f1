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
    forward alone, which writes no ``lse``.  DTensor operands run on each
    rank's shard (``flash_attention_sharded``)."""
    if is_dtensor(q):
        return flash_attention_sharded(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, mode=mode)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                      mode)
    return _flash_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, mode=mode)


def is_dtensor(t) -> bool:
    # torch.distributed.tensor is imported only where a DTensor can exist
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def shard_plan(q, k) -> tuple:
    """How the flash kernels take DTensors q ``[B, Sq, H, Dh]`` and k, v
    ``[B, Skv, Hkv, Dh]`` on one mesh: (q's placements, k's and v's, the
    placements of k's and v's gradients), one each a mesh dim.

    Per mesh dim, by q's placement there: batch split (``Shard(0)``): k and
    v split alike; heads split (``Shard(2)``): k and v split alike where
    their heads divide with the group size kept, else whole, each rank
    then reading the kv heads of its own query heads; query rows split
    (``Shard(1)``, sequence parallelism or the K/V gather): k and v whole;
    whole: k and v whole.  Where k and v are whole but q is split, each
    rank's dk and dv are a part of the sum (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    qp, kp, gp = [], [], []
    for i, p in enumerate(q.placements):
        n = mesh.shape[i]
        if p.is_shard(0) or (p.is_shard(2) and k.shape[2] % n == 0
                             and k.placements[i] == Shard(2)):
            qp.append(p)
            kp.append(p)
            gp.append(p)
        elif p.is_shard(1) or p.is_shard(2):
            if q.shape[p.dim] % n:
                raise ValueError(f"flash_attention: q {tuple(q.shape)} split "
                                 f"{n} ways on dim {p.dim}")
            qp.append(p)
            kp.append(Replicate())
            gp.append(Partial())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            gp.append(Replicate())
    return tuple(qp), tuple(kp), tuple(gp)


def run_sharded(q, k, v, fn):
    """``fn(q_local, k_local, v_local, row0)`` on each rank's local shards of
    DTensors q, k, v placed by ``shard_plan`` (through ``local_map``: no
    DTensor reaches ``fn``), its output placed as q is.  ``row0`` is the
    first global query row of the rank (its rows' share of a sequence
    split); a rank holding query heads ``[r H_l, (r + 1) H_l)`` beside
    whole k and v gets the kv heads of its own query heads (head ``h``
    reads kv head ``h // G``, as on one card)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    qp, kp, gp = shard_plan(q, k)
    g = q.shape[2] // k.shape[2]

    def local(ql, kl, vl):
        row0 = 0
        for i, p in enumerate(qp):
            r = mesh.get_local_rank(i)
            if p.is_shard(1):
                row0 += r * ql.shape[1]
            elif p.is_shard(2) and not kp[i].is_shard():
                first, hl = r * ql.shape[2], ql.shape[2]
                if hl % g == 0:           # whole groups: their kv heads
                    kl = kl[:, :, first // g:(first + hl) // g]
                    vl = vl[:, :, first // g:(first + hl) // g]
                elif g % hl == 0:         # a part of one group: its kv head
                    kl = kl[:, :, first // g:first // g + 1]
                    vl = vl[:, :, first // g:first // g + 1]
                else:                     # one kv head a query head
                    idx = (first + torch.arange(hl, device=kl.device)) // g
                    kl, vl = kl[:, :, idx], vl[:, :, idx]
        return fn(ql, kl, vl, row0)

    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, gp, gp), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def flash_attention_sharded(q, k, v, *, causal: bool = True, window=None,
                            q_offset: int = 0, mode: str = "auto"):
    """``flash_attention`` of DTensors: each rank's kernels (forward, and
    its backward under autograd) on its local shards (``run_sharded``); a
    rank holding query rows ``[r Sq_l, (r + 1) Sq_l)`` masks them from
    ``q_offset + r Sq_l``."""
    return run_sharded(q, k, v, lambda ql, kl, vl, row0: flash_attention(
        ql, kl, vl, causal=causal, window=window, q_offset=q_offset + row0,
        mode=mode))


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

