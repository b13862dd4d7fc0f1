"""Convergence bound Omega (Theorem 2 RHS), constraint C1 of Sec. 5.2.

Port of ``repro.core.convergence``.  Theorem 2 bounds the mean squared
gradient norm of the global loss:

    (1/T) sum_t E||grad F(w_t)||^2
      <= 2 [F(w0) - F(w*) + sqrt(K) * eta * rho * delta''^2] / (sqrt(T) * D)
       + (2 + L) * [rho + gamma0 * (S/N) * (Delta_i + delta_i^2) - delta_bar'] / D

    with  rho = E[J_s] / (N * E[J_i]),
          D   = 2 sqrt(K) * eta * rho + L * eta - 1.

The constants are not observable a priori; ``BoundParams.from_trace``
estimates them from a short training trace.  ``omega_bound`` is the host
float64 form, ``omega_bound_k`` the float32 torch form over the dense K
axis (``core.latency.optimize_k_masked``'s companion), whose fields may be
tensors of a batch shape ``[*G]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from .latency import _col, _device_of, k_axis


@dataclasses.dataclass
class BoundParams:
    L: float = 10.0              # Lipschitz constant of grad F
    # Theorem 2 requires eta >= 1/(L + 2K rho), i.e. eta on the order of 1/L;
    # smaller eta makes the bound's denominator negative (theorem vacuous).
    eta: float = 0.12            # E[eta^{t,k}]
    f_gap: float = 2.3           # F(w0) - F(w*)
    delta_pp_sq: float = 0.5     # delta''^2 — edge-gradient variance
    Delta_i: float = 0.01        # E[weight-difference drift] (Assumption 2.1)
    delta_i_sq: float = 0.01     # its variance bound
    delta_bar_p: float = 0.0     # delta_bar' — estimated-weight deviation
    gamma0: float = 0.9
    s_frac: float = 0.2          # E[S^t] / N — straggler fraction at edges
    j_ratio: float = 0.2         # rho = E[J_s] / (N E[J_i])
    T: int = 50

    @staticmethod
    def from_trace(losses: Sequence[float], grad_norms: Sequence[float],
                   weight_deltas: Sequence[float], eta: float, gamma0: float,
                   s_frac: float, j_ratio: float, T: int) -> "BoundParams":
        """Estimate the bound constants from an observed training trace:
        L from the grad-norm / weight-delta ratio (secant estimate of the
        Lipschitz constant); variances from trace dispersion."""
        losses = np.asarray(losses, dtype=np.float64)
        g = np.asarray(grad_norms, dtype=np.float64)
        d = np.asarray(weight_deltas, dtype=np.float64)
        dg = np.abs(np.diff(g))
        L = float(np.median(dg / np.maximum(d[: dg.size], 1e-9))) \
            if dg.size else 10.0
        return BoundParams(
            L=max(L, 1e-3),
            eta=eta,
            f_gap=float(max(losses[0] - losses.min(), 1e-3)),
            delta_pp_sq=float(np.var(g)) if g.size > 1 else 0.5,
            Delta_i=float(np.mean(d)) if d.size else 0.01,
            delta_i_sq=float(np.var(d)) if d.size > 1 else 0.01,
            delta_bar_p=0.0,
            gamma0=gamma0, s_frac=s_frac, j_ratio=j_ratio, T=T,
        )


def omega_bound(K: int, p: BoundParams) -> float:
    """Theorem 2's upper bound Omega as a function of K (float64); +inf
    where the step-size condition fails (denominator D <= 0), so the
    optimizer treats it as infeasible."""
    rho = p.j_ratio
    denom = 2.0 * math.sqrt(K) * p.eta * rho + p.L * p.eta - 1.0
    if denom <= 0:
        return float("inf")
    term1 = 2.0 * (p.f_gap + math.sqrt(K) * p.eta * rho * p.delta_pp_sq) \
        / (math.sqrt(p.T) * denom)
    straggler_pen = rho + p.gamma0 * p.s_frac * (p.Delta_i + p.delta_i_sq) \
        - p.delta_bar_p
    term2 = (2.0 + p.L) * straggler_pen / denom
    return term1 + term2


def omega_bound_k(p: BoundParams, k_max: int) -> torch.Tensor:
    """Omega over the dense K axis K = 1..k_max, float32 ``[*G, k_max]``
    (``[k_max]`` for host-scalar fields); +inf where the denominator is
    <= 0, like the scalar form."""
    fields = [getattr(p, f.name) for f in dataclasses.fields(p)]
    sqrt_k = torch.sqrt(k_axis(k_max, _device_of(*fields)))
    rho, eta, L = _col(p.j_ratio), _col(p.eta), _col(p.L)
    denom = 2.0 * sqrt_k * eta * rho + L * eta - 1.0
    sqrt_t = torch.sqrt(torch.as_tensor(_col(p.T), dtype=torch.float32,
                                        device=sqrt_k.device))
    term1 = 2.0 * (_col(p.f_gap) + sqrt_k * eta * rho * _col(p.delta_pp_sq)) \
        / (sqrt_t * denom)
    straggler_pen = rho + _col(p.gamma0) * _col(p.s_frac) * (
        _col(p.Delta_i) + _col(p.delta_i_sq)) - _col(p.delta_bar_p)
    term2 = (2.0 + L) * straggler_pen / denom
    return torch.where(denom > 0, term1 + term2, math.inf)
