"""HieAvg — the paper's hierarchical averaging aggregation (Sec. 3), in plain
PyTorch.

Port of ``repro.core.hieavg`` and the port's reference path: the engine's
kernel route (``repro_torch.kernels.dispatch``) is tested against it, and
it against the JAX functions.  Weights are dicts of *stacked* tensors: the
leading ``mask.dim()`` axes are batch axes then the participant axis
(``[n, ...]`` for one layer, ``[N, J, ...]`` for all N edges at once), so
every function below works on both without a ``vmap``.  The single-model
entry points (``edge_aggregate``, ``global_aggregate``,
``edge_aggregate_cold``, ``global_aggregate_cold`` on ``[n, ...]``
weights) serve ``run_legacy``.

History storage (``history_dtype``): ``prev_w``/``delta_mean`` may be kept
in ``torch.bfloat16`` or ``torch.float8_e4m3fn``; the math stays float32
and every store goes through ``to_history_dtype``, which casts as
``jnp.astype`` does.

Straggler estimation (Sec. 3.2.2): a straggler's missing submission is
estimated as ``w_prev + E[Delta]`` and scaled by ``gamma = gamma0 *
lam**k'``, k' >= 1 counting consecutive misses.  ``normalize=False`` is
the paper's eq. (4)/(5) as written; ``normalize=True`` divides by the sum
of the coefficients (beyond-paper, see ``repro.core.hieavg``).
"""
from __future__ import annotations

import dataclasses

import torch

f32 = torch.float32

#: the storage dtypes of a history besides float32
HISTORY_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)

#: float8_e4m3fn's largest finite value is 448; a float32 above 464 (the
#: midpoint to the next binade) rounds past it
_F8_LIMIT = 464.0


def to_history_dtype(x: torch.Tensor, dtype) -> torch.Tensor:
    """Cast a float32 tensor to a history storage dtype as ``jnp.astype``
    does.  bfloat16 and float32 are plain casts.  For float8_e4m3fn,
    ``Tensor.to`` saturates to +-448 (inf included) where JAX gives NaN:
    every |x| > 464, +-inf and NaN become a NaN of x's sign; the rest
    round to nearest even, as ``Tensor.to`` does."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    xf = x.to(f32)
    nan = torch.copysign(torch.full_like(xf, float("nan")), xf)
    return torch.where(xf.abs() <= _F8_LIMIT, xf, nan).to(dtype)


def _bshape(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape a [..., n] vector so it broadcasts against a [..., n, *leaf]
    leaf."""
    return v.reshape(tuple(v.shape) + (1,) * (leaf.dim() - v.dim()))


def per_row(x, like: torch.Tensor):
    """A per-row scalar (``gamma0``, ``lam``, the delayed-gradient ``beta``
    and ``delta``) against ``[*batch, n]`` coefficients: a host scalar as it
    is, a tensor of the leading batch axes (``[B]`` for ``[B, n]``, a
    sweep's ``[P]`` for ``[P, N, J]``) reshaped to broadcast over the
    rest."""
    if isinstance(x, torch.Tensor):
        return x.reshape(tuple(x.shape) + (1,) * (like.dim() - x.dim()))
    return x


@dataclasses.dataclass
class History:
    """Per-participant submission history: ``prev_w``/``delta_mean`` leaves
    shaped like the stacked weights, ``n_obs`` (observed deltas) and
    ``miss_count`` (consecutive misses) shaped like the mask."""

    prev_w: dict
    delta_mean: dict
    n_obs: torch.Tensor
    miss_count: torch.Tensor


def _init(stacked_w: dict, lead: int, dtype) -> History:
    first = next(iter(stacked_w.values()))
    shape = tuple(first.shape[:lead])
    dtype = dtype or first.dtype
    return History(
        prev_w={k: to_history_dtype(v, dtype) for k, v in stacked_w.items()},
        delta_mean={k: torch.zeros_like(v, dtype=dtype)
                    for k, v in stacked_w.items()},
        n_obs=torch.zeros(shape, dtype=f32, device=first.device),
        miss_count=torch.zeros(shape, dtype=f32, device=first.device))


def init_history(stacked_w: dict, dtype=None) -> History:
    """Cold-boot history from a first ``[n, ...]`` stacked submission;
    ``dtype`` (None, bfloat16 or float8_e4m3fn) is the storage dtype of
    ``prev_w``/``delta_mean``, None keeping the weights' own."""
    return _init(stacked_w, 1, dtype)


def init_history_batched(stacked_w: dict, dtype=None, lead: int = 2
                         ) -> History:
    """Cold-boot history for dense ``[N, J, ...]`` stacked weights
    (``lead`` batch and participant axes: 3 for a sweep's
    ``[P, N, J, ...]``)."""
    return _init(stacked_w, lead, dtype)


def update_history(history: History, stacked_w: dict,
                   mask: torch.Tensor) -> History:
    """Fold one round of submissions into the history.

    Present (mask True): delta = w - prev_w joins the running mean,
    prev_w <- w, miss_count <- 0.  Stragglers: prev_w advances by E[Delta],
    the delta stats freeze, miss_count += 1.

    As the reference, the estimate ``prev + dmean`` is rounded to the
    storage dtype before it is mixed (the warm path, ``_mix_and_update``,
    keeps it in float32).
    """
    m = mask.to(f32)
    new_prev, new_dmean = {}, {}
    for k, w in stacked_w.items():
        prev, dmean = history.prev_w[k], history.delta_mean[k]
        pf, df, wf = prev.to(f32), dmean.to(f32), w.to(f32)
        mb = _bshape(m, prev)
        nb = _bshape(history.n_obs, prev)
        est = to_history_dtype(pf + df, prev.dtype).to(f32)
        new_prev[k] = to_history_dtype(mb * wf + (1.0 - mb) * est,
                                       prev.dtype)
        mean = (df * nb + (wf - pf)) / (nb + 1.0)
        new_dmean[k] = to_history_dtype(mb * mean + (1.0 - mb) * df,
                                        dmean.dtype)
    return History(prev_w=new_prev, delta_mean=new_dmean,
                   n_obs=history.n_obs + m,
                   miss_count=(history.miss_count + 1.0) * (1.0 - m))


def update_history_batched(history: History, stacked_w: dict,
                           mask: torch.Tensor) -> History:
    """``update_history`` over ``[N, J, ...]`` weights and ``[N, J]`` masks
    (the leading edge axis is a batch axis)."""
    return update_history(history, stacked_w, mask)


def _mix_and_update(stacked_w: dict, mask: torch.Tensor, history: History,
                    part_weights: torch.Tensor, gamma0, lam,
                    normalize: bool) -> tuple[dict, History]:
    """Aggregate (eq. 4/5) and history update in one pass per leaf: float32
    math, the new history in its storage dtype.  ``gamma0``/``lam``: host
    scalars or per-row tensors (``per_row``)."""
    m = mask.to(f32)
    gamma = per_row(gamma0, m) * torch.pow(per_row(lam, m),
                                           history.miss_count + 1.0)  # k'>=1
    coef = part_weights * (m + (1.0 - m) * gamma)
    if normalize:
        coef = coef / torch.clamp(coef.sum(-1, keepdim=True), min=1e-12)
    coef_p = coef * m
    coef_e = coef * (1.0 - m)
    nb1 = history.n_obs + 1.0
    p_axis = m.dim() - 1
    agg, new_prev, new_dmean = {}, {}, {}
    for k, w in stacked_w.items():
        prev, dmean = history.prev_w[k], history.delta_mean[k]
        w, pf, df = w.to(f32), prev.to(f32), dmean.to(f32)
        est = pf + df
        agg[k] = (_bshape(coef_p, w) * w + _bshape(coef_e, w) * est
                  ).sum(p_axis)
        mb = _bshape(m, w)
        new_prev[k] = to_history_dtype(mb * w + (1.0 - mb) * est, prev.dtype)
        mean = (df * _bshape(history.n_obs, w) + (w - pf)) / _bshape(nb1, w)
        new_dmean[k] = to_history_dtype(mb * mean + (1.0 - mb) * df,
                                        dmean.dtype)
    return agg, History(prev_w=new_prev, delta_mean=new_dmean,
                        n_obs=history.n_obs + m,
                        miss_count=(history.miss_count + 1.0) * (1.0 - m))


def aggregate(stacked_w: dict, mask: torch.Tensor, history: History,
              part_weights: torch.Tensor, gamma0, lam,
              normalize: bool = False) -> tuple[dict, History]:
    """Eq. (4)/(5) with caller-normalized ``part_weights``."""
    return _mix_and_update(stacked_w, mask, history, part_weights, gamma0,
                           lam, normalize)


def edge_aggregate(stacked_w: dict, mask: torch.Tensor, history: History,
                   *, gamma0: float = 0.9, lam: float = 0.9,
                   normalize: bool = False) -> tuple[dict, History]:
    """Eq. (4) at one edge: ``[n, ...]`` weights, part weights ``1/n``.
    Returns (edge model, updated history)."""
    n = mask.shape[0]
    pw = torch.full((n,), 1.0 / n, dtype=f32, device=mask.device)
    return _mix_and_update(stacked_w, mask, history, pw, gamma0, lam,
                           normalize)


def global_aggregate(stacked_w: dict, mask: torch.Tensor, history: History,
                     j_per_edge: torch.Tensor, *, gamma0: float = 0.9,
                     lam: float = 0.9, normalize: bool = False
                     ) -> tuple[dict, History]:
    """Eq. (5) on the leader: ``[N, ...]`` edge models weighted by
    ``J_i / sum J``.  Returns (global model, updated history)."""
    j = j_per_edge.to(f32)
    return _mix_and_update(stacked_w, mask, history, j / j.sum(), gamma0,
                           lam, normalize)


def edge_aggregate_cold(stacked_w: dict) -> dict:
    """Eq. (2) during cold boot at one edge: the plain mean over its
    ``[n, ...]`` devices."""
    return {k: w.mean(0) for k, w in stacked_w.items()}


def edge_aggregate_batched(stacked_w: dict, mask: torch.Tensor,
                           history: History, valid: torch.Tensor, gamma0,
                           lam, normalize: bool = False
                           ) -> tuple[dict, History]:
    """Eq. (4) for all N edges: ``[N, J, ...]`` weights, ``[N, J]``
    mask/valid; part weights ``valid / max(J_e, 1)`` (zero on padded
    slots)."""
    v = valid.to(f32)
    pw = v / torch.clamp(v.sum(-1, keepdim=True), min=1.0)
    return _mix_and_update(stacked_w, mask, history, pw, gamma0, lam,
                           normalize)


def global_aggregate_cold(stacked_w: dict, j_per_edge: torch.Tensor) -> dict:
    """Eq. (3) during cold boot: the J_i-weighted mean over edge models; an
    all-zero ``j_per_edge`` row aggregates to exact zeros."""
    j = j_per_edge.to(f32)
    pw = j / torch.clamp(j.sum(-1, keepdim=True), min=1e-12)
    p_axis = pw.dim() - 1
    return {k: (_bshape(pw, w) * w).sum(p_axis) for k, w in stacked_w.items()}


def edge_aggregate_cold_batched(stacked_w: dict, valid: torch.Tensor) -> dict:
    """Eq. (2) for all edges at once: per-edge mean over valid slots."""
    return global_aggregate_cold(stacked_w, valid)
