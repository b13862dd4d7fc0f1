"""The train step's SGD update ``w - scale * g`` on the CUDA kernel of
``csrc/sgd_update.cu``: every leaf of a step in one launch.

Port of ``repro.kernels.sgd_update``, which is called once per leaf (and
vmapped over a sweep's points, one scale each); the port keeps its
per-leaf semantics and launches once per step.  ``scale`` is a host float
(the engine's ``lr`` plane lives on the host, so a step costs no
device-to-host sync), or a float32 vector of one scale per row of the
leaves' leading axis: a sweep's rows, whose points differ in lr and in
which steps are real.  Plain version: ``ref.sgd_update_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

#: the most leaves one launch takes (csrc/sgd_update.cu: MAX_LEAVES)
MAX_LEAVES = 64
#: ``build.LAUNCHES`` key of the launches with one scale a row
ROWS_COUNT = "sgd_update[rows]"


def sgd_update_many(ws, gs, scale, mode: str = "auto") -> list:
    """``[w - scale * g for w, g in zip(ws, gs)]``, float32 leaves, in one
    launch.  ``scale``: a host float, or a float32 tensor ``[rows]`` whose
    entry d scales row d of every leaf (leaves ``[rows, ...]``).  The
    results are views of one flat allocation; the leaves ``ws`` are not
    written."""
    rows = None
    if isinstance(scale, torch.Tensor):
        if scale.dim() != 1:
            raise TypeError("sgd_update: scale must be a host float or a "
                            f"[rows] vector, got shape {tuple(scale.shape)}")
        rows = scale.shape[0]
        for w in ws:
            if w.dim() == 0 or w.shape[0] != rows:
                raise ValueError(f"sgd_update: {rows} row scales for a "
                                 f"leaf {tuple(w.shape)}")
    if len(ws) != len(gs):
        raise ValueError(f"sgd_update: {len(ws)} leaves, {len(gs)} grads")
    if not ws or not build.use_kernel(mode, ws[0]):
        return [ref.sgd_update_ref(w, g, scale) for w, g in zip(ws, gs)]
    if len(ws) > MAX_LEAVES:
        raise ValueError(f"sgd_update: {len(ws)} leaves, one launch takes "
                         f"at most {MAX_LEAVES}")
    dev = ws[0].device
    if rows is not None:
        if scale.dtype != torch.float32 or scale.device != dev \
                or not scale.is_contiguous():
            raise ValueError(f"sgd_update: contiguous float32 row scales on "
                             f"{dev}, got {scale.dtype} on {scale.device}")
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
    # the per-row path counts apart: a sweep's rows, not a standalone step
    build.LAUNCHES["sgd_update" if rows is None else ROWS_COUNT] += 1
    with build.on_device(flat):
        build.check(build.library().sgd_update_launch(
            ptrs(*[w.data_ptr() for w in ws]),
            ptrs(*[g.data_ptr() for g in gs]),
            (ctypes.c_longlong * n)(*sizes), n, flat.data_ptr(),
            0.0 if rows is not None else float(scale),
            None if rows is None else scale.data_ptr(), rows or 0,
            build.stream()), "sgd_update")
    return outs


def sgd_update(w, g, scale, mode: str = "auto"):
    """``w - scale * g`` on one leaf of any shape; float32 (``scale`` as in
    ``sgd_update_many``)."""
    return sgd_update_many([w], [g], scale, mode)[0]
