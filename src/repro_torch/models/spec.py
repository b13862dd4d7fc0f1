"""Parameter specs and their initialisers (``repro.models.spec`` for the port).

Every parameter is a ``ParamSpec`` carrying a *logical* axis name per dim
(``("layers", "embed", "mlp")``; None = replicated), the reference's
names.  The launch layer maps them to mesh axes
(``repro_torch.launch.sharding``); models never name a mesh axis.

``init_params`` (the CNN's flat ``{name: ParamSpec}``) and
``init_from_specs`` (the LLM zoo's nested dicts) match
``repro.models.spec.init_from_specs`` in distribution: ``N(0, 1) /
sqrt(fan_in)`` for ``"normal"`` leaves, with the reference's fan-in rule
(``shape[-2]``, so ``wq [L, d, H, Dh]`` is scaled by ``1/sqrt(H)``), zeros
and ones for the others.  They draw from a ``torch.Generator``, so their
numbers differ from the JAX ones; a caller that needs the reference's
exact weights carries them over with ``params_from_numpy``
(``models.cnn``, ``models.transformer``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]   # logical name per dim, None: replicated
    dtype: torch.dtype = torch.float32
    init: str = "normal"              # normal | zeros | ones

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in length")


def _draw(spec: ParamSpec, generator, device, dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    # in place: one float32 leaf alive, not two
    v = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device).div_(np.sqrt(max(fan_in, 1)))
    return v.to(dtype)


def init_params(specs: dict, generator: torch.Generator,
                device="cpu", dtype=torch.float32) -> dict:
    """Materialize ``{name: tensor}`` from ``{name: ParamSpec}``, drawing
    the leaves in sorted-name order (the JAX pytree order) on the CPU."""
    return {name: _draw(specs[name], generator, "cpu", dtype).to(device)
            for name in sorted(specs)}


def init_from_specs(specs: dict, generator: Optional[torch.Generator],
                    device="cpu", dtype: Optional[torch.dtype] = None
                    ) -> dict:
    """Materialize a nested dict of ``ParamSpec`` leaves on ``device``, in
    ``dtype`` (each spec's own where None), drawing the leaves in sorted-key
    order (the JAX pytree order) from ``generator``, which lives on
    ``device``.  ``generator`` may be None where no leaf is ``"normal"``."""
    return {k: (_draw(v, generator, device, dtype or v.dtype)
                if isinstance(v, ParamSpec)
                else init_from_specs(v, generator, device, dtype))
            for k, v in sorted(specs.items())}


def iter_specs(specs: dict, prefix: str = ""):
    """``("a/b/c", ParamSpec)`` of a nested dict, in ``init_from_specs``'
    order (sorted keys, depth first)."""
    for k, v in sorted(specs.items()):
        if isinstance(v, ParamSpec):
            yield prefix + k, v
        else:
            yield from iter_specs(v, f"{prefix}{k}/")


def draw_leaves(specs: dict, generator: Optional[torch.Generator],
                device="cpu"):
    """``(path, leaf)`` of ``init_from_specs(specs, generator, device,
    dtype)`` one leaf at a time, each in float32: the same draws, and a
    leaf cast to ``dtype`` is ``init_from_specs``' leaf bitwise."""
    for path, spec in iter_specs(specs):
        yield path, _draw(spec, generator, device, torch.float32)


def count_params(specs: dict) -> int:
    return sum(int(np.prod(s.shape)) if isinstance(s, ParamSpec)
               else count_params(s) for s in specs.values())
