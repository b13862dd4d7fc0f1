"""The train step's SGD update ``w - scale * g`` on the CUDA kernel of
``csrc/sgd_update.cu``: every leaf of a step in one launch.

Port of ``repro.kernels.sgd_update``, which is called once per leaf; the
port keeps its per-leaf semantics and launches once per step.  ``scale``
is a host float (the engine's ``lr`` plane lives on the host), so a step
costs no device-to-host sync.  Plain version: ``ref.sgd_update_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the most leaves one launch takes (csrc/sgd_update.cu: MAX_LEAVES)
MAX_LEAVES = 64


def sgd_update_many(ws, gs, scale: float, mode: str = "auto") -> list:
    """``[w - scale * g for w, g in zip(ws, gs)]``, float32 leaves of any
    shape, in one launch.  The results are views of one flat allocation;
    the leaves ``ws`` are not written."""
    if isinstance(scale, torch.Tensor):
        raise TypeError("sgd_update: scale must be a host float")
    if len(ws) != len(gs):
        raise ValueError(f"sgd_update: {len(ws)} leaves, {len(gs)} grads")
    if not ws or not build.use_kernel(mode, ws[0]):
        return [ref.sgd_update_ref(w, g, scale) for w, g in zip(ws, gs)]
    if len(ws) > MAX_LEAVES:
        raise ValueError(f"sgd_update: {len(ws)} leaves, one launch takes "
                         f"at most {MAX_LEAVES}")
    dev = ws[0].device
    for w, g in zip(ws, gs):            # what the launch needs, no more
        if w.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError(f"sgd_update: float32 leaves, got {w.dtype}, "
                            f"{g.dtype}")
        if w.shape != g.shape or not (w.is_contiguous()
                                      and g.is_contiguous()):
            raise ValueError(f"sgd_update: contiguous w and g of one shape,"
                             f" got {tuple(w.shape)}, {tuple(g.shape)}")
        if w.device != dev or g.device != dev:
            raise ValueError(f"sgd_update: leaves on {w.device}, "
                             f"{g.device}, expected {dev}")
    sizes = [w.numel() for w in ws]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    # per-leaf views of the one allocation (as_strided costs the host a
    # third of split + view)
    outs, start = [], 0
    for w, n in zip(ws, sizes):
        outs.append(flat.as_strided(w.shape, w.stride(), start))
        start += n
    n = len(ws)
    ptrs = ctypes.c_void_p * n
    build.LAUNCHES["sgd_update"] += 1
    build.check(build.library().sgd_update_launch(
        ptrs(*[w.data_ptr() for w in ws]), ptrs(*[g.data_ptr() for g in gs]),
        (ctypes.c_longlong * n)(*sizes), n, flat.data_ptr(), float(scale),
        build.stream()), "sgd_update")
    return outs


def sgd_update(w, g, scale: float, mode: str = "auto"):
    """``w - scale * g`` on one leaf of any shape; float32."""
    return sgd_update_many([w], [g], scale, mode)[0]
