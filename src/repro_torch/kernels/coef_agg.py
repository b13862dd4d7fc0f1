"""The coefficient-weighted aggregates on the CUDA kernels of
``csrc/coef_agg.cu``: ``coef_agg``, ``sum_n coef[n] * w[n]`` (the
cold-boot means of both HieAvg layers, FedAvg), and ``coef_agg_pair``,
``sum_n ca[n] * w[n] + cb[n] * aux[n]`` (the delayed-gradient mix).

Port of ``repro.kernels.coef_agg``.  The leading batch axis is the
kernels' grid axis.  Plain versions: ``ref.coef_agg_ref`` and
``ref.coef_agg_pair_ref``.
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


def coef_agg_pair(w, aux, ca, cb, mode: str = "auto"):
    """w, aux [B, n, L] float32; ca, cb [B, n] -> float32 [B, L]."""
    if not build.use_kernel(mode, w):
        return ref.coef_agg_pair_ref(w, aux, ca, cb)
    B, n, L = w.shape
    build.expect(w, "w", (B, n, L))
    build.expect(aux, "aux", (B, n, L), device=w.device)
    coef = torch.stack([ca.to(torch.float32), cb.to(torch.float32)],
                       dim=1).contiguous()             # [B, 2, n]
    build.expect(coef, "coef", (B, 2, n), device=w.device)
    out = torch.empty((B, L), device=w.device, dtype=torch.float32)
    build.LAUNCHES["coef_agg_pair"] += 1
    build.check(build.library().coef_agg_pair_launch(
        w.data_ptr(), aux.data_ptr(), coef.data_ptr(), out.data_ptr(), B, n,
        L, build.stream()), "coef_agg_pair")
    return out
