"""Parameter specs and their initialiser (``repro.models.spec`` for the port).

``init_params`` matches ``repro.models.spec.init_from_specs`` in
distribution: ``N(0, 1) / sqrt(fan_in)`` for ``"normal"`` leaves, zeros for
the biases.  It draws from a ``torch.Generator``, so its numbers
differ from the JAX ones; a caller that needs the reference's exact weights
carries them over with ``repro_torch.models.cnn.params_from_numpy``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"              # normal | zeros


def init_params(specs: dict, generator: torch.Generator,
                device="cpu", dtype=torch.float32) -> dict:
    """Materialize ``{name: tensor}`` from ``{name: ParamSpec}``, drawing
    the leaves in sorted-name order (the JAX pytree order)."""
    out = {}
    for name in sorted(specs):
        spec = specs[name]
        if spec.init == "zeros":
            v = torch.zeros(spec.shape, dtype=dtype)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            v = torch.randn(spec.shape, generator=generator,
                            dtype=torch.float32) / np.sqrt(max(fan_in, 1))
            v = v.to(dtype)
        out[name] = v.to(device)
    return out


def count_params(specs: dict) -> int:
    return sum(int(np.prod(s.shape)) for s in specs.values())

