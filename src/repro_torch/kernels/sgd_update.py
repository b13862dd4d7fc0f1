"""The train step's SGD update ``w - scale * g`` on the CUDA kernel of
``csrc/sgd_update.cu``.

Port of ``repro.kernels.sgd_update``.  ``scale`` is a host float (the
engine's ``lr`` plane lives on the host), so a step costs no device-to-host
sync.  Plain version: ``ref.sgd_update_ref``.
"""
from __future__ import annotations

import torch

from . import build, ref


def sgd_update(w, g, scale: float, mode: str = "auto"):
    """``w - scale * g`` on one leaf of any shape; float32."""
    if isinstance(scale, torch.Tensor):
        raise TypeError("sgd_update: scale must be a host float")
    if not build.use_kernel(mode, w):
        return ref.sgd_update_ref(w, g, scale)
    build.expect(w, "w", tuple(w.shape))
    build.expect(g, "g", tuple(w.shape), device=w.device)
    out = torch.empty_like(w)
    build.LAUNCHES["sgd_update"] += 1
    build.check(build.library().sgd_update_launch(
        w.data_ptr(), g.data_ptr(), out.data_ptr(), w.numel(), float(scale),
        build.stream()), "sgd_update")
    return out
