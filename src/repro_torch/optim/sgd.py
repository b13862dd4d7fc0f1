"""Optimizers and the paper's decaying learning-rate schedule (Sec. 4.1).

Port of ``repro.optim.sgd``.  ``paper_lr`` is float32 numpy: the host
builds the lr planes with it, so it must be bitwise equal to
``repro.optim.sgd.paper_lr``, the same float32 operations in the same
order.  ``sgd_step`` and ``adam_step`` update a dict of parameter tensors
(nested as the model's) with float32 math, each result cast back to its
parameter's dtype, as the reference does; ``lr`` is a float32 value (a
numpy float32 or a 0-dim float32 tensor), not a Python double, so that
the product is the reference's float32 one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

f32 = torch.float32


def paper_lr(step, eta0: float = 1e-3, decay: float = 0.90) -> np.ndarray:
    """eta^{t,k} = 1 / (1/eta0 + d*step), with step = t*K + k, so that
    eta(0) == eta0.  float32 throughout."""
    f = np.float32
    s = np.asarray(step).astype(f)
    return f(1.0) / (f(1.0 / eta0) + f(decay) * s)


@dataclasses.dataclass
class OptState:
    """``mu``: momentum (SGD) or first moment (Adam); ``nu``: Adam's second
    moment or None; ``count``: steps taken."""

    mu: dict
    nu: Optional[dict]
    count: int


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _lr(lr, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.float32(lr) if not isinstance(
        lr, torch.Tensor) else lr, dtype=f32, device=like.device)


def sgd_leaf(p: torch.Tensor, u: torch.Tensor,
             lr: torch.Tensor) -> torch.Tensor:
    """``p - lr u`` in float32, cast back to p's dtype (``lr`` a float32
    tensor): every SGD update of the port goes through it."""
    return (p.to(f32) - lr * u.to(f32)).to(p.dtype)


def sgd_init(params: dict) -> OptState:
    return OptState(mu=tree_map(torch.zeros_like, params), nu=None, count=0)


def sgd_step(params: dict, grads: dict, state: OptState, lr,
             momentum: float = 0.0) -> tuple[dict, OptState]:
    """``p - lr * u`` with u the gradient, or with ``momentum`` the running
    ``momentum * mu + g`` (in the gradients' dtype, as the reference)."""
    if momentum:
        mu = tree_map(lambda m, g: momentum * m + g, state.mu, grads)
        upd = mu
    else:
        mu, upd = state.mu, grads
    return (tree_map(lambda p, u: sgd_leaf(p, u, _lr(lr, p)), params, upd),
            OptState(mu=mu, nu=None, count=state.count + 1))


def adam_init(params: dict) -> OptState:
    z = tree_map(lambda p: torch.zeros(p.shape, dtype=f32, device=p.device),
                 params)
    return OptState(mu=z, nu=tree_map(torch.zeros_like, z), count=0)


def adam_step(params: dict, grads: dict, state: OptState, lr,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
              ) -> tuple[dict, OptState]:
    """Adam with bias correction; moments in float32."""
    c = state.count + 1
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(f32), state.mu,
                  grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.to(f32).square(),
                  state.nu, grads)
    bc1 = 1 - np.float32(b1) ** np.float32(c)
    bc2 = 1 - np.float32(b2) ** np.float32(c)

    def upd(p, m, v):
        step = _lr(lr, p) * (m / float(bc1)) / (torch.sqrt(v / float(bc2))
                                                + eps)
        return (p.to(f32) - step).to(p.dtype)

    return tree_map(upd, params, mu, nu), OptState(mu=mu, nu=nu, count=c)
