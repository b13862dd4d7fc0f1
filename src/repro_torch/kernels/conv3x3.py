"""The CNN conv block ``relu(conv3x3_same(x, w) + b)`` on the implicit-GEMM
CUDA kernels of ``csrc/conv3x3.cu``.

Port of ``repro.kernels.conv3x3``, whose Pallas kernels ``_fwd_call``
(``relu(cols @ W + b)``) and ``_bwd_call`` (``dcols``, ``dW``, ``db``) run
on im2col patches built in XLA, ``dx`` coming from the autodiff of that
construction (col2im).  On the H100 the patches cost more than the
products (722 MB a step at the DEFAULT second layer, against an 80 MB
input), so here both passes read the input's halo from shared memory:

  forward   y  = relu(conv3x3_same(x, w) + b)                conv3x3_fwd
  backward  dz = dy * (y > 0), applied as dy is loaded       conv3x3_bwd
            dx = conv3x3_same(dz, w flipped, transposed)
                 (only when x needs a gradient)
            dW, db = per-row-run partials of sum_p x-taps * dz and
                     sum_p dz, summed here with torch.sum

Bound at the DEFAULT train shape of the second layer (D 25, 25088
pixels a device, Cin 32, Cout 64): 2.31e10 FLOPs a direction at the FP32
rate, 0.345 ms forward and 0.690 ms backward; the kernels stay in FP32.

Layouts are the JAX package's and the stacked device axis is the grid's:
x [D, B, H, W, Cin], w [D, 3, 3, Cin, Cout], b [D, Cout].  The autograd
function saves x, w and y, never patches.  Plain versions:
``ref.conv3x3_fwd_ref`` and ``ref.conv3x3_bwd_ref``.

Limits: none below the card's memory, as the reference's tiling of the
im2col rows takes any shape.  Rows wider than 224 pixels are split into
column segments; weights too wide for a block's shared memory are streamed
a chunk of channels at a time beside the input (the ``_ws`` kernels); the
dW pass (``conv3x3_dw_wide_kernel``) splits its channel groups and its
rows' columns over blocks until its stages fit.  A launch that fails raises (``build.check``).
"""
from __future__ import annotations

import torch

from . import build, ref

#: image rows (of a device's B*H) reduced into one dW/db partial by one
#: block of the backward kernel (the partials are summed outside,
#: deterministically)
ROWS_PER_PARTIAL = 32
#: the most devices one launch takes (the grid's z extent); more are split
#: across launches
MAX_DEVICES = 65535


def _device_runs(D: int):
    """(first device, devices) of each launch."""
    return [(d0, min(MAX_DEVICES, D - d0)) for d0 in range(0, D, MAX_DEVICES)]


def _at(t, d0: int):
    """The address of device ``d0``'s slice of ``t`` (None stays None)."""
    return None if t is None else t.data_ptr() + d0 * t.stride(0) * 4


def conv3x3_fwd(x, w, b, mode: str = "auto"):
    """``relu(conv3x3_same(x, w) + b)`` for each of D devices: x [D, B, H,
    W, Cin], w [D, 3, 3, Cin, Cout], b [D, Cout] -> [D, B, H, W, Cout]."""
    if not build.use_kernel(mode, x):
        return ref.conv3x3_fwd_ref(x, w, b)
    D, nb, h, wd, cin = x.shape
    cout = w.shape[-1]
    build.expect(x, "x", (D, nb, h, wd, cin))
    build.expect(w, "w", (D, 3, 3, cin, cout), device=x.device)
    build.expect(b, "b", (D, cout), device=x.device)
    y = torch.empty((D, nb, h, wd, cout), device=x.device,
                    dtype=torch.float32)
    with build.on_device(x):
        for d0, d in _device_runs(D):
            build.LAUNCHES["conv3x3_fwd"] += 1
            build.check(build.library().conv3x3_fwd_launch(
                _at(x, d0), _at(w, d0), _at(b, d0), _at(y, d0), d, nb * h, h,
                wd, cin, cout, build.stream()), "conv3x3_fwd")
    return y


def conv3x3_bwd(x, w, y, dy, need_dx: bool = True, mode: str = "auto"):
    """(dx or None, dW [D, 3, 3, Cin, Cout], db [D, Cout]) of
    ``conv3x3_fwd`` given its output ``y`` and the output gradient
    ``dy``."""
    if not build.use_kernel(mode, x):
        return ref.conv3x3_bwd_ref(x, w, y, dy, need_dx)
    D, nb, h, wd, cin = x.shape
    cout = w.shape[-1]
    build.expect(x, "x", (D, nb, h, wd, cin))
    for name, t, shape in (("w", w, (D, 3, 3, cin, cout)),
                           ("y", y, (D, nb, h, wd, cout)),
                           ("dy", dy, (D, nb, h, wd, cout))):
        build.expect(t, name, shape, device=x.device)
    nparts = -(-(nb * h) // ROWS_PER_PARTIAL)
    dx = torch.empty_like(x) if need_dx else None
    part = torch.empty((D, nparts, 9 * cin + 1, cout), device=x.device,
                       dtype=torch.float32)
    with build.on_device(x):
        for d0, d in _device_runs(D):
            build.LAUNCHES["conv3x3_bwd"] += 1
            build.check(build.library().conv3x3_bwd_launch(
                _at(x, d0), _at(w, d0), _at(y, d0), _at(dy, d0), _at(dx, d0),
                _at(part, d0), d, nb * h, h, wd, cin, cout, ROWS_PER_PARTIAL,
                build.stream()), "conv3x3_bwd")
    total = part.sum(1)                              # [D, 9*Cin + 1, Cout]
    return dx, total[:, :9 * cin].reshape(w.shape), total[:, 9 * cin]


class _Conv3x3BiasRelu(torch.autograd.Function):
    """relu(conv3x3_same(x, w) + b) with a kernel on both passes; saves x,
    w and y."""

    @staticmethod
    def forward(ctx, x, w, b, mode):
        x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
        y = conv3x3_fwd(x, w, b, mode)
        ctx.save_for_backward(x, w, y)
        ctx.mode = mode
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        dx, dw, db = conv3x3_bwd(x, w, y, dy.contiguous(),
                                 ctx.needs_input_grad[0], ctx.mode)
        return dx, dw, db, None


def conv3x3_bias_relu(x, w, b, mode: str = "auto"):
    """``relu(conv3x3_same(x, w) + b)``, differentiable in x, w and b.

    Stacked: x [D, ..., H, W, Cin], w [D, 3, 3, Cin, Cout], b [D, Cout].
    Single model: x [..., H, W, Cin], w [3, 3, Cin, Cout], b [Cout].
    Semantics = ``repro.kernels.ref.conv3x3_bias_relu_ref`` per device.
    """
    if w.dim() == 4:
        return conv3x3_bias_relu(x[None], w[None], b[None], mode)[0]
    D, h, wd, cin = w.shape[0], x.shape[-3], x.shape[-2], x.shape[-1]
    y = _Conv3x3BiasRelu.apply(x.reshape(D, -1, h, wd, cin), w, b, mode)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))
