"""The coefficient-weighted aggregates on the CUDA kernel of
``csrc/coef_agg.cu``: ``coef_agg``, ``sum_n coef[n] * w[n]`` (the
cold-boot means of both HieAvg layers, FedAvg), and ``coef_agg_pair``,
``sum_n ca[n] * w[n] + cb[n] * aux[n]`` (the delayed-gradient mix); every
leaf of an aggregate in one launch.

Port of ``repro.kernels.coef_agg``, which is called once per leaf and
vmapped over the engine's edge axis.  Here the leading batch axes (the
engine's edges; none at the global layer) are the kernel's grid axis, and
one launch takes every leaf.  Plain versions: ``ref.coef_agg_ref`` and
``ref.coef_agg_pair_ref`` per leaf.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, ref
from .leaves import ALIGN, MAX_LEAVES, plan


def coef_agg_many(ws, coef, mode: str = "auto") -> list:
    """``sum_n coef[..., n] * w[..., n, ...]`` of every leaf in one launch.

    coef ``[*lead]``, its last axis the n participants; each leaf
    ``[*lead, *leaf]``.  Returns the float32 ``[*lead[:-1], *leaf]``
    aggregate of each leaf; on the card they are views of one flat
    allocation."""
    lead = tuple(coef.shape)
    if not ws or not build.use_kernel(mode, ws[0]):
        return [ref.coef_agg_ref(_flat("coef_agg", w, lead), coef)
                .reshape(_agg_shape(w, lead)) for w in ws]
    return _launch("coef_agg", [ws], [coef], lead)


def coef_agg_pair_many(ws, auxes, ca, cb, mode: str = "auto") -> list:
    """``sum_n ca[..., n] * w[..., n, ...] + cb[..., n] * aux[..., n, ...]``
    of every leaf in one launch: the delayed-gradient mix.

    ca, cb ``[*lead]``; each leaf's w and aux ``[*lead, *leaf]``.  Returns
    the float32 ``[*lead[:-1], *leaf]`` aggregate of each leaf; on the card
    they are views of one flat allocation."""
    if len(ws) != len(auxes):
        raise ValueError(f"coef_agg_pair: {len(ws)} leaves, {len(auxes)} "
                         "aux")
    lead = tuple(ca.shape)
    if tuple(cb.shape) != lead:
        raise ValueError(f"coef_agg_pair: ca {lead}, cb {tuple(cb.shape)}")
    if not ws or not build.use_kernel(mode, ws[0]):
        return [ref.coef_agg_pair_ref(_flat("coef_agg_pair", w, lead),
                                      _flat("coef_agg_pair", x, lead), ca, cb)
                .reshape(_agg_shape(w, lead)) for w, x in zip(ws, auxes)]
    return _launch("coef_agg_pair", [ws, auxes], [ca, cb], lead)


def _flat(name: str, w, lead: tuple):
    """``[*lead, *leaf]`` -> ``[*lead, L]`` (the plain versions' layout)."""
    if tuple(w.shape[:len(lead)]) != lead:
        raise ValueError(f"{name}: leaf {tuple(w.shape)} does not lead with "
                         f"the coefficients' shape {lead}")
    return w.reshape(lead + (-1,))


def _agg_shape(w, lead: tuple) -> tuple:
    return lead[:-1] + tuple(w.shape[len(lead):])


def _launch(name: str, operands: list, coefs: list, lead: tuple) -> list:
    """One launch of ``name`` over the leaves: ``operands`` is ``[ws]`` or
    ``[ws, auxes]``, ``coefs`` ``[coef]`` or ``[ca, cb]``."""
    ws = operands[0]
    if len(ws) > MAX_LEAVES:
        raise ValueError(f"{name}: {len(ws)} leaves, one launch takes at "
                         f"most {MAX_LEAVES}")
    dev, f32 = ws[0].device, torch.float32   # a CUDA device (use_kernel)
    for c in coefs:
        if c.device != dev:
            raise ValueError(f"{name}: coefficients on {c.device}, leaves "
                             f"on {dev}")
    coef = (coefs[0] if len(coefs) == 1 else
            torch.stack(coefs, dim=-2)).to(f32).contiguous()  # [*b, (2,) n]
    cols, starts, total, views = plan(name, lead,
                                      tuple([w.shape for w in ws]))
    ptrs, vec, keep = [], [], []
    for k, w in enumerate(ws):
        aligned = cols[k] % ALIGN == 0       # and every operand's address
        for leaf in (ops[k] for ops in operands):
            if leaf.dtype is not f32:
                raise TypeError(f"{name}: float32 leaves, got {leaf.dtype}")
            if leaf.device != dev:
                raise ValueError(f"{name}: leaves on {leaf.device} and "
                                 f"{dev}")
            if leaf.shape != w.shape:
                raise ValueError(f"{name}: w {tuple(w.shape)}, aux "
                                 f"{tuple(leaf.shape)}")
            if not leaf.is_contiguous():
                leaf = leaf.contiguous()
                keep.append(leaf)             # alive until the launch
            p = leaf.data_ptr()
            aligned = aligned and p % 16 == 0
            ptrs.append(p)
        vec.append(int(aligned))
    B, n = math.prod(lead[:-1]), lead[-1]
    out = torch.empty(B * total, dtype=f32, device=dev)
    k = len(ws)
    build.LAUNCHES[name] += 1
    with build.on_device(out):
        build.check(getattr(build.library(), name + "_launch")(
            (ctypes.c_void_p * len(ptrs))(*ptrs), cols, starts,
            (ctypes.c_int * k)(*vec), k, coef.data_ptr(), out.data_ptr(), B,
            n, build.stream()), name)
    # per-leaf views of the one allocation (as_strided is the cheapest view
    # the host can make)
    view = out.as_strided
    return [view(shape, stride, off) for shape, stride, off, *_ in views]


def coef_agg(w, coef, mode: str = "auto"):
    """One leaf: w [B, n, L] float32, coef [B, n] -> float32 [B, L]."""
    return coef_agg_many([w], coef, mode)[0]


def coef_agg_pair(w, aux, ca, cb, mode: str = "auto"):
    """One leaf: w, aux [B, n, L] float32; ca, cb [B, n] -> float32
    [B, L]."""
    return coef_agg_pair_many([w], [aux], ca, cb, mode)[0]
