"""The scalar float64 part of ``repro.core.latency`` (Sec. 5), for the port.

``LatencyParams`` carries the expectation-level constants of Sec. 5.1 plus
the dispersion knobs the engine's per-round clock draws from
(``repro_torch.fl.engine.build_inputs``).  ``total_latency`` is the paper's
simplified expectation form

    L ~= T*N*J*K*(2*E[LM] + E[LP]) + 2*T*N*E[LM']

The dense traced K-axis solvers of the reference module come with a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


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


def total_latency(K: int, p: LatencyParams) -> float:
    """L(K) — Sec. 5.1.4 simplified expectation form (float64)."""
    local = p.T * p.N * p.J * K * (2.0 * p.lm_device + p.lp_device)
    edge = 2.0 * p.T * p.N * p.lm_edge
    return local + edge


def edge_window(K: int, p: LatencyParams) -> float:
    """L_g = K * max(LM + LP): time the blockchain has to finish consensus."""
    return K * (p.lm_device + p.lp_device)
