"""Latency model and K* optimization (Sec. 5), for the port.

Port of ``repro.core.latency``.  Communication uses Shannon capacity
r = B log2(1 + u*pi/eps^2); transmission latency is D/r; compute latency
is C/f.  ``total_latency`` is the paper's simplified expectation form

    L ~= T*N*J*K*(2*E[LM] + E[LP]) + 2*T*N*E[LM']

and the optimization (Sec. 5.2) picks the number of edge rounds K
minimizing L subject to C1: Omega(K) <= Omega_bar (the convergence bound,
``core.convergence``), C2: L_bc <= L_g(K) (consensus hidden inside the
edge window) and C3: K in N+, solved by enumeration over a dense
``[K_max]`` axis in two implementations with one masked-argmin semantics:

  * ``optimize_k`` -- the host float64 reference (``KOptResult`` or None);
  * ``total_latency_k``/``edge_window_k`` + ``optimize_k_masked`` -- float32
    torch tensors over the K axis.  Any field of ``LatencyParams`` may be a
    tensor of batch shape ``[*G]`` (where the reference vmaps over
    ``dataclasses.replace``'d params), and the results are then
    ``[*G, k_max]``: a whole grid of K* solves is one batched call, on the
    device its tensors lie on.

``LatencyParams`` also carries the dispersion knobs the engine's per-round
clock draws from (``repro_torch.fl.engine.build_inputs``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch


def shannon_rate(bandwidth_hz: float, tx_power: float, channel_gain: float,
                 noise: float) -> float:
    """r = B log2(1 + u*pi / eps^2)  [bits/s]."""
    return bandwidth_hz * math.log2(1.0 + tx_power * channel_gain / noise ** 2)


def comm_latency(model_bytes: float, rate_bps: float) -> float:
    """LM = D / r (D in bits)."""
    return model_bytes * 8.0 / rate_bps


def compute_latency(cpu_cycles: float, clock_hz: float) -> float:
    """LP = C / f."""
    return cpu_cycles / clock_hz


@dataclasses.dataclass
class LatencyParams:
    """Sec. 5.1 expectations (the paper's measured 1.67 s local training,
    0.51 s device<->edge transfer, 0.05 s edge<->leader hop) and the
    engine's per-round dispersion knobs."""
    T: int = 50            # global rounds
    N: int = 5             # edge servers
    J: int = 5             # devices per edge
    lm_device: float = 0.51   # E[LM]   device<->edge one-way
    lp_device: float = 1.67   # E[LP]   local training per edge round
    lm_edge: float = 0.05     # E[LM']  edge<->leader one-way
    # A device's round draw is 2*lm_device*U(1±lm_jitter) +
    # lp_device*U(1±lp_jitter); a straggler is delayed by
    # ``straggler_slowdown`` and the edge closes the round at the deadline
    # ``deadline_mult * (2 lm + lp)`` without it.
    lm_jitter: float = 0.08
    lp_jitter: float = 0.08
    straggler_slowdown: float = 2.5
    deadline_mult: float = 1.5
    # per-device clock-rate multipliers [D] of a heterogeneous fleet
    # (None = homogeneous)
    rate_mult: Optional[np.ndarray] = None


def round_time(p: LatencyParams) -> float:
    """Expected single edge-round time per device: 2 E[LM] + E[LP]."""
    return 2.0 * p.lm_device + p.lp_device


def device_deadline(p: LatencyParams) -> float:
    """The edge's per-round submission deadline (Sec. 2.4)."""
    return p.deadline_mult * round_time(p)


# ----------------------------------------------------- scalar reference
def total_latency(K: int, p: LatencyParams) -> float:
    """L(K) — Sec. 5.1.4 simplified expectation form (float64)."""
    local = p.T * p.N * p.J * K * (2.0 * p.lm_device + p.lp_device)
    edge = 2.0 * p.T * p.N * p.lm_edge
    return local + edge


def edge_window(K: int, p: LatencyParams) -> float:
    """L_g = K * max(LM + LP): time the blockchain has to finish consensus."""
    return K * (p.lm_device + p.lp_device)


# -------------------------------------------------------- dense K axis
def _col(x):
    """A batched field ``[*G]`` as a ``[*G, 1]`` column against the K
    axis; a host scalar as it is."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def _device_of(*xs):
    """The device of the first tensor among ``xs`` (the CPU if none)."""
    return next((x.device for x in xs if isinstance(x, torch.Tensor)),
                torch.device("cpu"))


def k_axis(k_max: int, device=None) -> torch.Tensor:
    """The dense K enumeration axis: [1, 2, ..., k_max] as float32."""
    return torch.arange(1, k_max + 1, dtype=torch.float32, device=device)


def total_latency_k(p: LatencyParams, k_max: int) -> torch.Tensor:
    """L(K) over the dense K axis: ``[*G, k_max]`` float32 (``[k_max]``
    when every field is a host scalar)."""
    ks = k_axis(k_max, _device_of(p.T, p.N, p.J, p.lm_device, p.lp_device,
                                  p.lm_edge))
    T, N, J = _col(p.T), _col(p.N), _col(p.J)
    local = T * N * J * ks * (2.0 * _col(p.lm_device) + _col(p.lp_device))
    return local + 2.0 * T * N * _col(p.lm_edge)


def edge_window_k(p: LatencyParams, k_max: int) -> torch.Tensor:
    """L_g(K) over the dense K axis: ``[*G, k_max]`` float32."""
    ks = k_axis(k_max, _device_of(p.lm_device, p.lp_device))
    return ks * (_col(p.lm_device) + _col(p.lp_device))


def optimize_k_masked(latencies: torch.Tensor, omegas: torch.Tensor,
                      windows: torch.Tensor, omega_bar, consensus_latency
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked-argmin K* solve over ``[*G, K_max]`` arrays.

    ``omega_bar`` and ``consensus_latency`` are host scalars or tensors of
    the batch shape ``[*G]``.  Returns ``(k_star, latency, feasible)``:
    ``k_star`` int32 ``[*G]`` (-1 where no K is feasible, and ``latency``
    +inf there), ``feasible`` bool ``[*G, K_max]``.  The first of equal
    latencies wins, as ``jnp.argmin``."""
    feas = (omegas <= _col(omega_bar)) & (_col(consensus_latency) <= windows)
    lat = torch.where(feas, latencies, torch.full_like(latencies, math.inf))
    idx = torch.argmin(lat, dim=-1)
    any_f = feas.any(dim=-1)
    k_star = torch.where(any_f, idx + 1, -1).to(torch.int32)
    best = torch.gather(lat, -1, idx[..., None])[..., 0]
    return k_star, torch.where(any_f, best, math.inf), feas


# -------------------------------------------------------- host optimizer
@dataclasses.dataclass
class KOptResult:
    k_star: int
    latency: float
    feasible: np.ndarray     # [K_max] bool
    latencies: np.ndarray    # [K_max]
    omegas: np.ndarray       # [K_max]


def optimize_k(p: LatencyParams, omega_fn: Callable[[int], float],
               omega_bar: float, consensus_latency: float,
               k_max: int = 64) -> Optional[KOptResult]:
    """argmin_K L(K)  s.t.  Omega(K) <= Omega_bar, L_bc <= L_g(K), K >= 1,
    in float64 on the host; None when no K <= k_max is feasible.  Every K
    is enumerated (``omega_fn`` need not be monotone)."""
    if int(k_max) != k_max or k_max < 1:
        raise ValueError(f"optimize_k: k_max must be a positive integer, "
                         f"got {k_max!r}")
    k_max = int(k_max)
    if not np.isfinite(omega_bar):
        raise ValueError(f"optimize_k: omega_bar must be finite, got "
                         f"{omega_bar!r} — an infinite/NaN bound makes "
                         "constraint C1 vacuous or unsatisfiable")
    if not np.isfinite(consensus_latency) or consensus_latency < 0:
        raise ValueError(f"optimize_k: consensus_latency must be finite "
                         f"and >= 0, got {consensus_latency!r}")
    ks = np.arange(1, k_max + 1)
    lat = np.array([total_latency(int(k), p) for k in ks])
    om = np.array([omega_fn(int(k)) for k in ks])
    win = np.array([edge_window(int(k), p) for k in ks])
    feas = (om <= omega_bar) & (consensus_latency <= win)
    if not feas.any():
        return None
    idx = int(np.argmin(np.where(feas, lat, np.inf)))
    return KOptResult(k_star=int(ks[idx]), latency=float(lat[idx]),
                      feasible=feas, latencies=lat, omegas=om)
