"""The leaf tables of the kernels that take every leaf of an aggregate in
one launch (``hieavg_agg``, ``coef_agg``, ``coef_agg_pair``).

Leaves arrive shaped ``[*lead, *leaf]``: ``lead`` is the coefficients'
shape, its last axis the n participants, the axes before it the B rows
(the engine's edges; none at the global layer).  Leaf k is flattened to
``L_k`` columns; in the kernels' flat outputs it starts at column
``start[k]``, a multiple of ``ALIGN``, of each row block, so that an
aligned leaf's rows take the kernels' 16-byte path.
"""
from __future__ import annotations

import ctypes
import functools
import math

#: the most leaves one launch takes (MAX_LEAVES of csrc/hieavg_agg.cu and
#: csrc/coef_agg.cu)
MAX_LEAVES = 64
#: each leaf's first column in the flat outputs is a multiple of this
#: (VEC of the kernels: columns a thread on the 16-byte path)
ALIGN = 4


def contiguous_strides(shape: tuple) -> tuple:
    strides, s = [], 1
    for d in reversed(shape):
        strides.append(s)
        s *= max(d, 1)
    return tuple(reversed(strides))


@functools.lru_cache(maxsize=64)
def plan(kernel: str, lead: tuple, shapes: tuple) -> tuple:
    """For leaves ``[*lead, *leaf]``: the ctypes arrays of each leaf's
    columns and first output column, the total columns, and for each leaf
    the shape, strides and offset of its ``[*lead[:-1], *leaf]`` view in a
    flat ``[B, total]`` output and of its ``[*lead, *leaf]`` view in a flat
    ``[B, n, total]`` one.  Cached by the shapes: a run aggregates the
    same ones."""
    B, n = math.prod(lead[:-1]), lead[-1]
    cols, starts, views, start = [], [], [], 0
    for shape in shapes:
        if tuple(shape[:len(lead)]) != lead:
            raise ValueError(f"{kernel}: leaf {tuple(shape)} does not "
                             f"lead with the coefficients' shape {lead}")
        L = math.prod(shape[len(lead):])
        agg_shape = lead[:-1] + tuple(shape[len(lead):])
        views.append((agg_shape, contiguous_strides(agg_shape), B * start,
                      tuple(shape), contiguous_strides(tuple(shape)),
                      B * n * start))
        cols.append(L)
        starts.append(start)
        start += -(-L // ALIGN) * ALIGN
    k = len(shapes)
    return ((ctypes.c_longlong * k)(*cols), (ctypes.c_longlong * k)(*starts),
            start, views)
