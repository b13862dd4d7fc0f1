"""The paper's benchmark aggregators (Sec. 6.1.6), in plain PyTorch.

Port of ``repro.core.baselines``:

  * ``fedavg``   — the (weighted) mean of all submissions; with no
                   stragglers this is the W/O-Stragglers oracle.
  * ``t_fedavg`` — only timely submissions are averaged (stragglers
                   dropped).
  * ``d_fedavg`` — stragglers represented by their last submitted
                   weights, verbatim.
  * ``delayed_grad`` — a straggler's update arrives one round late and is
                   mixed in with a staleness-discounted weight
                   ("Stragglers Are Not Disaster", arXiv:2102.06329).

Weights are dicts of stacked tensors whose leading axes are batch axes
then the participant axis, like ``core.hieavg``: ``[..., n]`` coefficients
are normalized over their last axis, so the engine's ``[N, J]`` edges go
through without a ``vmap``.  ``fedavg`` and ``delayed_grad`` are the
reference paths of ``kernels.dispatch``; ``t_fedavg`` and ``d_fedavg`` run
no kernel here or in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from .hieavg import _bshape, per_row

f32 = torch.float32


def _weighted_mean(stacked_w: dict, coef: torch.Tensor) -> dict:
    """``sum_n coef_n * w_n / max(sum coef, 1e-12)``: an all-zero
    coefficient row aggregates to exact zeros."""
    coef = coef / torch.clamp(coef.sum(-1, keepdim=True), min=1e-12)
    p_axis = coef.dim() - 1
    return {k: (_bshape(coef, w) * w).sum(p_axis)
            for k, w in stacked_w.items()}


def fedavg(stacked_w: dict, part_weights: Optional[torch.Tensor] = None
           ) -> dict:
    """Weighted mean of all submissions (uniform over ``[n, ...]`` leaves
    when ``part_weights`` is None)."""
    if part_weights is None:
        first = next(iter(stacked_w.values()))
        part_weights = torch.ones(first.shape[:1], dtype=f32,
                                  device=first.device)
    return _weighted_mean(stacked_w, part_weights.to(f32))


def t_fedavg(stacked_w: dict, mask: torch.Tensor,
             part_weights: Optional[torch.Tensor] = None) -> dict:
    """Timely-only FedAvg: renormalized over the present participants; a
    set with none present aggregates to exact zeros."""
    m = mask.to(f32)
    if part_weights is None:
        part_weights = torch.ones_like(m)
    return _weighted_mean(stacked_w, part_weights * m)


def _fill(stacked_w: dict, m: torch.Tensor, store: dict) -> dict:
    """Present slots from ``stacked_w``, missing ones from ``store``."""
    out = {}
    for k, w in stacked_w.items():
        mb = _bshape(m, w)
        out[k] = mb * w + (1.0 - mb) * store[k]
    return out


def d_fedavg(stacked_w: dict, mask: torch.Tensor, last_w: dict,
             part_weights: Optional[torch.Tensor] = None
             ) -> tuple[dict, dict]:
    """Delayed-weights FedAvg: straggler slots filled with their last
    submissions.  Returns (aggregate, updated ``last_w`` store)."""
    m = mask.to(f32)
    if part_weights is None:
        part_weights = torch.ones_like(m)
    filled = _fill(stacked_w, m, last_w)
    return _weighted_mean(filled, part_weights), filled


def delayed_grad(stacked_w: dict, mask: torch.Tensor, pending: dict,
                 age: torch.Tensor, beta, delta,
                 part_weights: Optional[torch.Tensor] = None
                 ) -> tuple[dict, dict, torch.Tensor]:
    """Delayed-gradient aggregation with staleness-discounted weights: a
    missing slot's pending update counts with ``beta**k'``, ``k' = age +
    1`` consecutive misses, and not at all once ``k' > delta``; the
    coefficients are renormalized.  Returns (aggregate, new pending =
    ``stacked_w``, new age: 0 where present, ``age + 1`` where missing).
    First-round semantics (everyone present) are the caller's job.
    ``beta``/``delta``: host scalars or per-row tensors (``per_row``)."""
    m = mask.to(f32)
    if part_weights is None:
        part_weights = torch.ones_like(m)
    k_prime = age + 1.0
    stale_c = (per_row(beta, m) ** k_prime) \
        * (k_prime <= per_row(delta, m)).to(f32)
    coef = part_weights * (m + (1.0 - m) * stale_c)
    filled = _fill(stacked_w, m, pending)
    return _weighted_mean(filled, coef), stacked_w, (age + 1.0) * (1.0 - m)
