"""HieAvg's mix and history update in one pass, on the CUDA kernel of
``csrc/hieavg_agg.cu``.

Port of ``repro.kernels.hieavg_agg``.  The leading batch axis (the
engine's edges; 1 at the global layer) is the kernel's grid axis, where
the JAX package vmaps.  Plain version: ``ref.hieavg_agg_ref``.
"""
from __future__ import annotations

import torch

from . import build, ref

#: the history storage dtypes the kernel takes, by its ``hist`` code
HIST_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def hieavg_agg(w, prev, dmean, mask, coef_present, coef_est, n_obs,
               mode: str = "auto"):
    """w [B, n, L] float32; prev/dmean [B, n, L] in one history dtype
    (float32, bfloat16 or float8_e4m3fn); mask/coefs/n_obs [B, n].
    Returns (agg [B, L] float32, new_prev, new_dmean [B, n, L] in the
    history dtype)."""
    if not build.use_kernel(mode, w):
        return ref.hieavg_agg_ref(w, prev, dmean, mask, coef_present,
                                  coef_est, n_obs)
    B, n, L = w.shape
    if prev.dtype not in HIST_CODES:
        raise TypeError(f"prev: expected one of {list(HIST_CODES)}, got "
                        f"{prev.dtype}")
    build.expect(w, "w", (B, n, L))
    build.expect(prev, "prev", (B, n, L), dtype=prev.dtype, device=w.device)
    build.expect(dmean, "dmean", (B, n, L), dtype=prev.dtype,
                 device=w.device)
    vec = torch.stack([mask.to(torch.float32), coef_present.to(torch.float32),
                       coef_est.to(torch.float32), n_obs.to(torch.float32)],
                      dim=1).contiguous()              # [B, 4, n]
    build.expect(vec, "vec", (B, 4, n), device=w.device)
    agg = torch.empty((B, L), device=w.device, dtype=torch.float32)
    nprev = torch.empty_like(prev)
    ndmean = torch.empty_like(dmean)
    build.LAUNCHES["hieavg_agg"] += 1
    build.check(build.library().hieavg_agg_launch(
        w.data_ptr(), prev.data_ptr(), dmean.data_ptr(), vec.data_ptr(),
        agg.data_ptr(), nprev.data_ptr(), ndmean.data_ptr(), B, n, L,
        HIST_CODES[prev.dtype], build.stream()), "hieavg_agg")
    return agg, nprev, ndmean
