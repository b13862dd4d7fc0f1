"""The engine's entry points to the kernel plane.

Port of ``repro.kernels.dispatch``.  Every entry takes ``mode``
(``"auto" | "cuda" | "torch"``, see ``build.use_kernel``) and runs each
kernel of its phase on the card or its plain PyTorch version; the
coefficient recipes of the reference are kept exactly, including the
``1e-12`` floors of the cold-boot means, FedAvg and the delayed-gradient
mix, and the ``max(sum v, 1)`` floor of the warm edge layer.  Leading
batch axes are allowed: ``[..., n]`` coefficients are normalized over
their last axis (where the reference vmaps over the edges).  The
``t_fedavg`` and ``d_fedavg`` baselines run no kernel in the reference
either; they stay in ``core.baselines``.
"""
from __future__ import annotations

import torch

from repro_torch.core.hieavg import History, per_row

from . import ops
from .build import KERNEL_MODES
from .conv3x3 import conv3x3_bias_relu as _conv3x3_bias_relu
from .eval_head import eval_head as _eval_head

#: The engine round phases that run in a kernel, in round order.
ROUND_PHASES = ("train_conv_fwd_bwd", "sgd_update", "warm_edge_aggregate",
                "warm_global_aggregate", "cold_boot_aggregate",
                "fedavg_aggregate", "delayed_grad_aggregate", "eval_head")


def resolve_kernel_mode(mode: str = "auto", device=None) -> str:
    """The path ``mode`` takes on ``device``, as ``build.use_kernel`` picks
    it for a tensor there: ``"auto"`` is ``"cuda"`` on a CUDA device and
    ``"torch"`` elsewhere; ``"cuda"`` and ``"torch"`` pass through; any
    other string raises, naming ``KERNEL_MODES``.  ``device`` None is the
    entry points' default: CUDA where a GPU is present."""
    if mode not in KERNEL_MODES:
        raise ValueError(
            f"unknown kernel_mode {mode!r}; expected one of {KERNEL_MODES}")
    if mode != "auto":
        return mode
    if device is None:
        return "cuda" if torch.cuda.is_available() else "torch"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def fused_phase_coverage(mode: str = "auto", device=None) -> dict:
    """Which round phases run in a kernel under ``mode`` on ``device``:
    ``{phase: bool}`` over ``ROUND_PHASES``."""
    fused = resolve_kernel_mode(mode, device) == "cuda"
    return {phase: fused for phase in ROUND_PHASES}


def edge_aggregate_batched(stacked_w: dict, mask: torch.Tensor,
                           history: History, valid: torch.Tensor, gamma0,
                           lam, normalize: bool = False, *,
                           mode: str = "auto") -> tuple[dict, History]:
    """Eq. (4) for all N edges (``hieavg.edge_aggregate_batched``)."""
    return ops.fused_edge_aggregate_batched(stacked_w, mask, history, valid,
                                            gamma0, lam, normalize,
                                            mode=mode)


def global_aggregate(stacked_w: dict, mask: torch.Tensor, history: History,
                     part_weights: torch.Tensor, gamma0, lam,
                     normalize: bool = False, *, mode: str = "auto"
                     ) -> tuple[dict, History]:
    """Eq. (5) on the leader (``hieavg.aggregate``)."""
    return ops.fused_mix_and_update(stacked_w, mask, history, part_weights,
                                    gamma0, lam, normalize, mode=mode)


def sgd_update(params: dict, grads: dict, scale, *,
               mode: str = "auto") -> dict:
    """The train step's ``w - scale * g`` per leaf; ``scale`` a host float
    or one scale per row of the leaves' leading (device) axis."""
    return ops.fused_sgd_update(params, grads, scale, mode=mode)


def conv3x3_bias_relu(x, w, b, *, mode: str = "auto"):
    """The CNN conv block ``relu(conv3x3_same(x, w) + b)``."""
    return _conv3x3_bias_relu(x, w, b, mode=mode)


def eval_head(feats, wmat, bias, labels, *, mode: str = "auto"):
    """Correct-prediction count of the classifier head."""
    return _eval_head(feats, wmat, bias, labels, mode=mode)


def edge_aggregate_cold_batched(stacked_w: dict, valid: torch.Tensor, *,
                                mode: str = "auto") -> dict:
    """Cold-boot edge mean for all N edges (eq. 2); an all-invalid edge
    aggregates to exact zeros."""
    v = valid.to(torch.float32)
    pw = v / torch.clamp(v.sum(-1, keepdim=True), min=1e-12)
    return ops.fused_coef_aggregate(stacked_w, pw, mode=mode)


def global_aggregate_cold(stacked_w: dict, j_per_edge: torch.Tensor, *,
                          mode: str = "auto") -> dict:
    """Cold-boot global J_i-weighted mean (eq. 3), over the last axis of
    ``j_per_edge`` (``[N]``, or a sweep's ``[P, N]``)."""
    j = j_per_edge.to(torch.float32)
    pw = j / torch.clamp(j.sum(-1, keepdim=True), min=1e-12)
    return ops.fused_coef_aggregate(stacked_w, pw, mode=mode)


def fedavg(stacked_w: dict, part_weights: torch.Tensor, *,
           mode: str = "auto") -> dict:
    """Weighted FedAvg (``baselines.fedavg``) on the ``coef_agg`` kernel:
    ``coef = pw / max(sum pw, 1e-12)``."""
    pw = part_weights.to(torch.float32)
    coef = pw / torch.clamp(pw.sum(-1, keepdim=True), min=1e-12)
    return ops.fused_coef_aggregate(stacked_w, coef, mode=mode)


def delayed_grad(stacked_w: dict, mask: torch.Tensor, pending: dict,
                 age: torch.Tensor, beta, delta, part_weights: torch.Tensor,
                 *, mode: str = "auto") -> tuple[dict, dict, torch.Tensor]:
    """Delayed-gradient aggregation (``baselines.delayed_grad``) on the
    ``coef_agg_pair`` kernel: a present slot adds ``coef * w``, a missing
    one its staleness-discounted pending update ``coef * p``, with
    ``k' = age + 1``, ``coef = pw * (m + (1 - m) * beta**k' * (k' <=
    delta))`` normalized.  Returns (aggregate, new pending = ``stacked_w``,
    new age = ``(age + 1) * (1 - m)``)."""
    m = mask.to(torch.float32)
    k_prime = age + 1.0
    stale_c = (per_row(beta, m) ** k_prime) \
        * (k_prime <= per_row(delta, m)).to(torch.float32)
    coef = part_weights * (m + (1.0 - m) * stale_c)
    coef = coef / torch.clamp(coef.sum(-1, keepdim=True), min=1e-12)
    agg = ops.fused_coef_aggregate_pair(stacked_w, pending, coef * m,
                                        coef * (1.0 - m), mode=mode)
    return agg, stacked_w, (age + 1.0) * (1.0 - m)
