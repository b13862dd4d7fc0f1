"""The CNN conv block ``relu(conv3x3_same(x, w) + b)`` on the CUDA kernels
of ``csrc/conv3x3.cu``.

Port of ``repro.kernels.conv3x3``.  The im2col construction (pad + nine
shifted slices) stays in PyTorch, as it stays in XLA there: its autograd
is col2im, so ``dx`` comes for free, and the ``torch.autograd.Function``
below covers only the matmul + bias + ReLU core:

  forward   y  = relu(cols @ W + b)                 conv3x3_fwd
  backward  dz = dy * (y > 0)                       conv3x3_bwd
            dcols = dz @ W^T    (only when cols needs a gradient)
            dW, db = per-row-run partials of [cols^T; 1] @ dz,
                     summed here with torch.sum

The stacked device axis is the kernels' batch axis: cols [D, M, 9*Cin],
W [D, 9*Cin, Cout], b [D, Cout].  Plain version: ``ref.matmul_bias_relu_ref``
and ``ref.matmul_bias_relu_bwd_ref``.
"""
from __future__ import annotations

import torch

from . import build, ref

#: rows of cols reduced into one dW/db partial by one block of the
#: backward kernel (the partials are summed outside, deterministically)
ROWS_PER_PARTIAL = 2048


def matmul_bias_relu_fwd(cols, wmat, bias, mode: str = "auto"):
    """``relu(cols @ wmat + bias)`` for each of D devices."""
    if not build.use_kernel(mode, cols):
        return ref.matmul_bias_relu_ref(cols, wmat, bias)
    D, M, K = cols.shape
    N = wmat.shape[-1]
    build.expect(cols, "cols", (D, M, K))
    build.expect(wmat, "wmat", (D, K, N), device=cols.device)
    build.expect(bias, "bias", (D, N), device=cols.device)
    if D > 65535:
        raise ValueError(f"conv3x3_fwd: D={D} exceeds the grid's z limit")
    y = torch.empty((D, M, N), device=cols.device, dtype=torch.float32)
    build.LAUNCHES["conv3x3_fwd"] += 1
    build.check(build.library().conv3x3_fwd_launch(
        cols.data_ptr(), wmat.data_ptr(), bias.data_ptr(), y.data_ptr(),
        D, M, K, N, build.stream()), "conv3x3_fwd")
    return y


def matmul_bias_relu_bwd(cols, wmat, y, dy, need_dcols: bool = True,
                         mode: str = "auto"):
    """(dcols or None, dW [D, K, N], db [D, N]) of ``matmul_bias_relu_fwd``
    given its output ``y`` and the output gradient ``dy``."""
    if not build.use_kernel(mode, cols):
        return ref.matmul_bias_relu_bwd_ref(cols, wmat, y, dy, need_dcols)
    D, M, K = cols.shape
    N = wmat.shape[-1]
    build.expect(cols, "cols", (D, M, K))
    for name, t, shape in (("wmat", wmat, (D, K, N)), ("y", y, (D, M, N)),
                           ("dy", dy, (D, M, N))):
        build.expect(t, name, shape, device=cols.device)
    nt = -(-M // ROWS_PER_PARTIAL)
    if D * nt > 65535:
        raise ValueError(f"conv3x3_bwd: {D} x {nt} partials exceed the "
                         "grid's z limit")
    dcols = torch.empty_like(cols) if need_dcols else None
    part = torch.empty((D, nt, K + 1, N), device=cols.device,
                       dtype=torch.float32)
    build.LAUNCHES["conv3x3_bwd"] += 1
    build.check(build.library().conv3x3_bwd_launch(
        cols.data_ptr(), wmat.data_ptr(), y.data_ptr(), dy.data_ptr(),
        None if dcols is None else dcols.data_ptr(), part.data_ptr(),
        D, M, K, N, ROWS_PER_PARTIAL, build.stream()), "conv3x3_bwd")
    total = part.sum(1)                              # [D, K + 1, N]
    return dcols, total[:, :K], total[:, K]


class _MatmulBiasRelu(torch.autograd.Function):
    """relu(cols @ wmat + bias) with a kernel on both passes."""

    @staticmethod
    def forward(ctx, cols, wmat, bias, mode):
        cols, wmat, bias = (cols.contiguous(), wmat.contiguous(),
                            bias.contiguous())
        y = matmul_bias_relu_fwd(cols, wmat, bias, mode)
        ctx.save_for_backward(cols, wmat, y)
        ctx.mode = mode
        return y

    @staticmethod
    def backward(ctx, dy):
        cols, wmat, y = ctx.saved_tensors
        dcols, dw, db = matmul_bias_relu_bwd(
            cols, wmat, y, dy.contiguous(), ctx.needs_input_grad[0],
            ctx.mode)
        return dcols, dw, db, None


def conv3x3_bias_relu(x, w, b, mode: str = "auto"):
    """``relu(conv3x3_same(x, w) + b)``, differentiable in x, w and b.

    Stacked: x [D, ..., H, W, Cin], w [D, 3, 3, Cin, Cout], b [D, Cout].
    Single model: x [..., H, W, Cin], w [3, 3, Cin, Cout], b [Cout].
    Semantics = ``ref.conv3x3_bias_relu_ref`` per device.
    """
    if w.dim() == 4:
        return conv3x3_bias_relu(x[None], w[None], b[None], mode)[0]
    D, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    cols = ref.im2col3x3(x).reshape(D, -1, 9 * cin)
    y = _MatmulBiasRelu.apply(cols, w.reshape(D, 9 * cin, cout), b, mode)
    return y.reshape(x.shape[:-1] + (cout,))
