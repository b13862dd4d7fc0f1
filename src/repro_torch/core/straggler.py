"""Copy of ``repro.core.straggler`` for the port, which imports nothing of ``repro``.

Keep the two in step: the port's host plane must stay bitwise equal to the
reference (``tests/test_torch_host_plane.py``).

Straggler schedules (Sec. 2.4, 6.1.2).

A schedule is a boolean array ``[rounds, n]`` with True = submitted in time.
Permanent stragglers stop submitting after ``stop_round`` (paper: round 40);
temporary stragglers miss individual rounds but return the next round.

Schedules are sampled host-side with numpy (they model external network
conditions, not traced computation) and fed to the jitted steps as arrays.
"""
from __future__ import annotations

import numpy as np


def no_stragglers(rounds: int, n: int) -> np.ndarray:
    return np.ones((rounds, n), dtype=bool)


def permanent(rounds: int, n: int, n_stragglers: int, stop_round: int = 40,
              seed: int = 0) -> np.ndarray:
    """``n_stragglers`` participants never submit again after ``stop_round``."""
    rng = np.random.default_rng(seed)
    mask = np.ones((rounds, n), dtype=bool)
    idx = rng.choice(n, size=min(n_stragglers, n), replace=False)
    mask[stop_round:, idx] = False
    return mask


def temporary(rounds: int, n: int, n_stragglers: int, miss_prob: float = 0.5,
              seed: int = 0, cold_boot_rounds: int = 2) -> np.ndarray:
    """``n_stragglers`` participants each miss random single rounds.

    A missed round is always followed by a submitted round (the paper's
    temporary stragglers "continue to submit in the next round after the
    missing round").  Cold-boot rounds are never missed (Alg. 1 assumes all
    devices submit during T_c).
    """
    rng = np.random.default_rng(seed)
    mask = np.ones((rounds, n), dtype=bool)
    idx = rng.choice(n, size=min(n_stragglers, n), replace=False)
    for i in idx:
        r = cold_boot_rounds
        while r < rounds:
            if rng.random() < miss_prob:
                mask[r, i] = False
                r += 2  # forced return next round
            else:
                r += 1
    return mask


def stack_ragged(schedules: list[np.ndarray], j_max: int | None = None,
                 n_max: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Stack per-edge ragged schedules into one dense device-layer tensor.

    ``schedules``: per-edge boolean arrays ``[rounds, J_e]`` (the output of
    ``from_fraction`` per edge).  Returns ``(dense, valid)`` where ``dense``
    is ``[rounds, N, J_max]`` with padded slots False (always-straggling —
    they carry zero aggregation weight anyway) and ``valid`` is ``[N, J_max]``
    marking real device slots.  This is the layout the jitted engine consumes:
    one gather instead of N ragged slices per round.

    ``j_max`` / ``n_max`` pad the device and edge dimensions past this
    deployment's own extents — the sweep fabric stacks grids whose points
    disagree on topology by padding every point to the grid maximum.  A
    padded edge is a fully-invalid row: all its slots read False in both
    ``dense`` and ``valid``, so it carries zero aggregation weight
    everywhere downstream.
    """
    rounds = schedules[0].shape[0]
    if any(s.shape[0] != rounds for s in schedules):
        raise ValueError("all per-edge schedules need the same round count")
    n = n_max if n_max is not None else len(schedules)
    if len(schedules) > n:
        raise ValueError(f"{len(schedules)} edges > n_max={n}")
    jm = j_max if j_max is not None else max(s.shape[1] for s in schedules)
    dense = np.zeros((rounds, n, jm), dtype=bool)
    valid = np.zeros((n, jm), dtype=bool)
    for e, sched in enumerate(schedules):
        je = sched.shape[1]
        if je > jm:
            raise ValueError(f"edge {e} has {je} devices > j_max={jm}")
        dense[:, e, :je] = sched
        valid[e, :je] = True
    return dense, valid


def from_fraction(rounds: int, n: int, frac: float, kind: str = "temporary",
                  **kw) -> np.ndarray:
    """Paper basic setting: 20% stragglers per layer -> n_stragglers = frac*n."""
    k = int(round(frac * n))
    if kind == "permanent":
        return permanent(rounds, n, k, **kw)
    if kind == "temporary":
        return temporary(rounds, n, k, **kw)
    if kind == "none":
        return no_stragglers(rounds, n)
    raise ValueError(f"unknown straggler kind: {kind}")
