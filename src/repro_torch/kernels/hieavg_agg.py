"""HieAvg's mix and history update in one pass, on the CUDA kernel of
``csrc/hieavg_agg.cu``: every leaf of an aggregate in one launch.

Port of ``repro.kernels.hieavg_agg``, which is called once per leaf and
vmapped over the engine's edge axis.  Here the leading batch axes (the
engine's edges; none at the global layer) are the kernel's grid axis, and
one launch takes every leaf.  Plain version: ``ref.hieavg_agg_ref`` per
leaf.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref
from .leaves import MAX_LEAVES, plan

#: the history storage dtypes the kernel takes, by its ``hist`` code
HIST_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def hieavg_agg_many(ws, prevs, dmeans, mask, coef_present, coef_est, n_obs,
                    mode: str = "auto"):
    """The HieAvg mix and history update of every leaf in one launch.

    mask/coef_present/coef_est/n_obs [*batch, n]; each leaf's w float32
    and prev/dmean, in one history dtype for all leaves (float32, bfloat16
    or float8_e4m3fn), shaped ``[*batch, n, *leaf]`` (``[B, n, L]`` with
    one batch axis and flat leaves).  Returns three lists: agg
    ``[*batch, *leaf]`` float32, new_prev and new_dmean shaped like the
    leaf in the history dtype; on the card each list is views of one flat
    allocation."""
    if not len(ws) == len(prevs) == len(dmeans):
        raise ValueError(f"hieavg_agg: {len(ws)} leaves, {len(prevs)} prev, "
                         f"{len(dmeans)} dmean")
    lead = tuple(mask.shape)
    if not ws or not build.use_kernel(mode, ws[0]):
        return _plain(ws, prevs, dmeans, mask, coef_present, coef_est,
                      n_obs, lead)
    if len(ws) > MAX_LEAVES:
        raise ValueError(f"hieavg_agg: {len(ws)} leaves, one launch takes "
                         f"at most {MAX_LEAVES}")
    hdt, f32 = prevs[0].dtype, torch.float32
    if hdt not in HIST_CODES:
        raise TypeError(f"prev: expected one of {list(HIST_CODES)}, got "
                        f"{hdt}")
    dev = ws[0].device                  # a CUDA device (use_kernel)
    vecs = []
    for name, v in (("mask", mask), ("coef_present", coef_present),
                    ("coef_est", coef_est), ("n_obs", n_obs)):
        if v.dtype is not f32 or not v.is_contiguous():
            v = v.to(f32).contiguous()
        if v.shape != mask.shape or v.device != dev:
            raise ValueError(f"{name}: expected shape {lead} on {dev}, got "
                             f"{tuple(v.shape)} on {v.device}")
        vecs.append(v)                  # alive until the launch
    ptrs = []
    for w, p, d in zip(ws, prevs, dmeans):   # what the launch needs, no more
        if w.dtype is not f32 or p.dtype is not hdt or d.dtype is not hdt:
            raise TypeError(f"hieavg_agg: float32 w and {hdt} history, got "
                            f"{w.dtype}, {p.dtype}, {d.dtype}")
        if not (w.is_contiguous() and p.is_contiguous() and d.is_contiguous()
                and w.shape == p.shape == d.shape):
            raise ValueError(f"hieavg_agg: contiguous w, prev and dmean of "
                             f"one shape, got {tuple(w.shape)}, "
                             f"{tuple(p.shape)}, {tuple(d.shape)}")
        if w.device != dev or p.device != dev or d.device != dev:
            raise ValueError(f"hieavg_agg: leaves on {w.device}, {p.device},"
                             f" {d.device}, expected {dev}")
        ptrs += (w.data_ptr(), p.data_ptr(), d.data_ptr())
    cols, starts, total, views = plan("hieavg_agg", lead,
                                      tuple([w.shape for w in ws]))
    B, n = math.prod(lead[:-1]), lead[-1]
    agg = torch.empty(B * total, dtype=f32, device=dev)
    nprev = torch.empty(B * n * total, dtype=hdt, device=dev)
    ndmean = torch.empty(B * n * total, dtype=hdt, device=dev)
    build.LAUNCHES["hieavg_agg"] += 1
    with build.on_device(agg):
        build.check(build.library().hieavg_agg_launch(
            (ctypes.c_void_p * len(ptrs))(*ptrs), cols, starts, len(ws),
            (ctypes.c_void_p * 4)(*[v.data_ptr() for v in vecs]),
            agg.data_ptr(), nprev.data_ptr(), ndmean.data_ptr(), B, n,
            HIST_CODES[hdt], build.stream()), "hieavg_agg")
    # per-leaf views of the three allocations (as_strided is the cheapest
    # view the host can make)
    a_view, p_view, d_view = agg.as_strided, nprev.as_strided, \
        ndmean.as_strided
    aggs, nprevs, ndmeans = [], [], []
    for ashape, astride, aoff, hshape, hstride, hoff in views:
        aggs.append(a_view(ashape, astride, aoff))
        nprevs.append(p_view(hshape, hstride, hoff))
        ndmeans.append(d_view(hshape, hstride, hoff))
    return aggs, nprevs, ndmeans


def _plain(ws, prevs, dmeans, mask, coef_present, coef_est, n_obs, lead):
    """``ref.hieavg_agg_ref`` leaf by leaf, each flattened to
    ``[*lead, L]``."""
    aggs, nprevs, ndmeans = [], [], []
    for w, p, d in zip(ws, prevs, dmeans):
        leaf = tuple(w.shape[len(lead):])
        flat = lead + (math.prod(leaf),)
        a, np_, nd = ref.hieavg_agg_ref(w.reshape(flat), p.reshape(flat),
                                        d.reshape(flat), mask, coef_present,
                                        coef_est, n_obs)
        aggs.append(a.reshape(lead[:-1] + leaf))
        nprevs.append(np_.reshape(w.shape))
        ndmeans.append(nd.reshape(w.shape))
    return aggs, nprevs, ndmeans


def hieavg_agg(w, prev, dmean, mask, coef_present, coef_est, n_obs,
               mode: str = "auto"):
    """One leaf: w [B, n, L] float32; prev/dmean [B, n, L] in one history
    dtype (float32, bfloat16 or float8_e4m3fn); mask/coefs/n_obs [B, n].
    Returns (agg [B, L] float32, new_prev, new_dmean [B, n, L] in the
    history dtype)."""
    aggs, nprevs, ndmeans = hieavg_agg_many([w], [prev], [dmean], mask,
                                            coef_present, coef_est, n_obs,
                                            mode)
    return aggs[0], nprevs[0], ndmeans[0]
