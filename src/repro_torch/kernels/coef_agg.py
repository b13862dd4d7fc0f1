"""The coefficient-weighted aggregate ``sum_n coef[n] * w[n]`` (the cold-boot
means of both HieAvg layers) on the CUDA kernel of ``csrc/coef_agg.cu``.

Port of ``repro.kernels.coef_agg.coef_agg``; the pair form
``coef_agg_pair`` (delayed-gradient aggregation) comes with a later slice.
The leading batch axis is the kernel's grid axis.  Plain version:
``ref.coef_agg_ref``.
"""
from __future__ import annotations

import torch

from . import build, ref


def coef_agg(w, coef, mode: str = "auto"):
    """w [B, n, L] float32, coef [B, n] -> float32 [B, L]."""
    if not build.use_kernel(mode, w):
        return ref.coef_agg_ref(w, coef)
    B, n, L = w.shape
    build.expect(w, "w", (B, n, L))
    coef = coef.to(torch.float32).contiguous()
    build.expect(coef, "coef", (B, n), device=w.device)
    out = torch.empty((B, L), device=w.device, dtype=torch.float32)
    build.LAUNCHES["coef_agg"] += 1
    build.check(build.library().coef_agg_launch(
        w.data_ptr(), coef.data_ptr(), out.data_ptr(), B, n, L,
        build.stream()), "coef_agg")
    return out
