"""The paper's decaying learning-rate schedule (Sec. 4.1), in float32 numpy.

``build_inputs`` fills the engine's ``lr`` plane with ``paper_lr`` on the
host, so it must be bitwise equal to ``repro.optim.sgd.paper_lr``: the same
float32 operations in the same order.
"""
from __future__ import annotations

import numpy as np


def paper_lr(step, eta0: float = 1e-3, decay: float = 0.90) -> np.ndarray:
    """eta^{t,k} = 1 / (1/eta0 + d*step), with step = t*K + k, so that
    eta(0) == eta0.  float32 throughout."""
    f32 = np.float32
    s = np.asarray(step).astype(f32)
    return f32(1.0) / (f32(1.0 / eta0) + f32(decay) * s)
