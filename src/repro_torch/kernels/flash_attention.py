"""Flash attention over GQA heads on the CUDA kernels of
``csrc/flash_attention.cu``: ``softmax(q kᵀ / sqrt(Dh)) v`` with causal and
sliding-window masks, the ``[Sq, Skv]`` logits never stored.

Port of ``repro.kernels.flash_attention.flash_attention_1h`` with the
batch, kv-head and group ``vmap`` of ``repro.kernels.ops.flash_attention``
as the kernel's grid axes.  The input type picks the kernel: bfloat16 runs
on tensor cores (``wgmma``, operands loaded by TMA), float32 on FP32 FMA
(``DESIGNS``).  Plain version: ``ref.flash_attention_ref``.

The gradient (``FlashAttentionFn``, which ``ops.flash_attention`` takes
when an input requires one) runs the three kernels of
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``) from the
forward's output and its rows' log-sum-exp; their plain version is
``ref.flash_attention_bwd_ref``.  The Pallas kernel has no backward: the
JAX package differentiates its XLA attention (``_sdpa``) instead.

The kernels are built at the head dims of ``HEAD_DIMS``; any other head dim
up to the largest runs on the smallest built one above it, its operands
zero-padded and the scale that of the true head dim (``_kernel_head_dim``):
zero columns add nothing to ``q kᵀ``, the log-sum-exp or ``do oᵀ``, and
the padded columns of every output are cut off again.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import build, ref

#: the head dims the kernels are built for (csrc/flash_attention.cu,
#: csrc/flash_attention_bwd.cu); 96 and 192 are multi-head latent
#: attention's (``models.mla``: nope + rope), 256 recurrentgemma's
HEAD_DIMS = (32, 64, 80, 96, 128, 192, 256)
#: input types and the launcher's code for each
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the design each input type launches, by its kernel's name
DESIGNS = {torch.float32: "flash_attention_kernel (FP32 FMA)",
           torch.bfloat16: "flash_attention_wgmma_kernel (bf16 wgmma, TMA "
                           "kv ring; 64-row kv tiles above Dh 128, "
                           "32-row above Dh 192)"}
#: the backward's design per input type, by its dk/dv and dq kernels' names
BWD_DESIGNS = {torch.float32: "flash_bwd_dkdv_kernel, flash_bwd_dq_kernel "
                              "(FP32 FMA; 32-row tiles above Dh 192)",
               torch.bfloat16: "flash_bwd_dkdv_wgmma_kernel, "
                               "flash_bwd_dq_wgmma_kernel (bf16 wgmma, TMA "
                               "ring, P and dS in BWD_TERMS bf16 terms; "
                               "dk/dv in a dV and a dK pass above Dh 128; "
                               "32-row streamed tiles above Dh 192)"}
#: bf16 terms each of P and dS is split into in the bfloat16 backward
#: (``TERMS`` in csrc/flash_attention_bwd.cu)
BWD_TERMS = 2


def _tma_strides(name: str, t: torch.Tensor) -> list:
    """The batch, sequence and head strides of a bfloat16 operand for its
    TMA tensor map, which needs a 16-byte-aligned address and strides of
    multiples of 16 bytes.  A dim of length 1 is never stepped, so its
    stride is replaced by a valid one."""
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name}'s address is not 16-byte "
                         "aligned, which the bfloat16 kernel's TMA loads "
                         "need")
    strides = [st if n > 1 else t.shape[3]
               for n, st in zip(t.shape[:3], t.stride()[:3])]
    if any(st * t.element_size() % 16 for st in strides):
        raise ValueError(f"flash_attention: {name}'s strides "
                         f"{tuple(t.stride())} are not multiples of 16 bytes,"
                         " which the bfloat16 kernel's TMA loads need")
    return strides


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def _kernel_head_dim(name: str, dh: int) -> int:
    """The built head dim a call at head dim ``dh`` runs on: the smallest of
    ``HEAD_DIMS`` at or above it; above the largest, ``ValueError``."""
    if dh < 1 or dh > HEAD_DIMS[-1]:
        raise ValueError(f"{name}: head dim {dh}; the kernels run head dims "
                         f"1 to {HEAD_DIMS[-1]} (built for {HEAD_DIMS}, "
                         "others zero-padded to the next)")
    return next(d for d in HEAD_DIMS if d >= dh)


def _pad_head_dim(dp: int, *ts) -> list:
    """Each tensor's last dim zero-padded to ``dp`` (a new contiguous
    tensor), or the tensor itself where it is ``dp`` wide already."""
    return [t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))
            for t in ts]


def _check_kernel_args(name: str, window, *ts) -> None:
    """What every flash kernel takes besides a built head dim (the caller
    pads to one): one input type of ``DTYPES``, the head dim contiguous,
    one CUDA device, grid extents."""
    q = ts[0]
    B, H = q.shape[0], q.shape[2]
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name}: operands in one of {list(DTYPES)}, got "
                        f"{[t.dtype for t in ts]}")
    for t in ts:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: every operand's head dim must be "
                             "contiguous")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: an operand on {t.device}, expected "
                             f"{q.device}")
    if window is not None and window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    if B > 65535 or H > 65535:           # the grid's y and z limits
        raise ValueError(f"{name}: batch {B} or heads {H} over 65535")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        mode: str = "auto", lse: bool = False):
    """GQA flash attention: q [B, Sq, H, Dh]; k, v [B, Skv, Hkv, Dh], H a
    multiple of Hkv -> (out [B, Sq, H, Dh] in ``v.dtype``, and with ``lse``
    each row's log-sum-exp of its scaled logits, [B, H, Sq] float32, +inf
    for a row that sees no key; else None).  Scale 1/sqrt(Dh).  A head dim
    that no kernel is built for runs zero-padded (``_kernel_head_dim``).

    The query heads are (Hkv, G) in that order, as the reference's reshape
    to [B, Sq, Hkv, G, Dh]: head h reads kv head ``h // G``.  Query row i
    sits at absolute position ``q_offset + i``.  The kernel reads the
    operands through their strides (the head dim contiguous) and takes
    float32 or bfloat16, all three alike; a bfloat16 operand whose address
    or strides break a TMA precondition raises before any launch.  Asking
    for ``lse`` changes no value of ``out``."""
    _check_shapes(q, k, v)
    if not build.use_kernel(mode, q):
        o, l = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
        return o, (l if lse else None)
    B, Sq, H, Dh = q.shape
    dp = _kernel_head_dim("flash_attention", Dh)
    q, k, v = _pad_head_dim(dp, q, k, v)
    _check_kernel_args("flash_attention", window, q, k, v)
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        strides = [_tma_strides(n, t) for n, t in (("q", q), ("k", k),
                                                    ("v", v))]
    else:
        strides = [t.stride()[:3] for t in (q, k, v)]
    out = torch.empty((B, Sq, H, dp), dtype=v.dtype, device=q.device)
    rows = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if lse else None
    build.LAUNCHES["flash_attention"] += 1
    build.check(build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if rows is None else rows.data_ptr(), B, H, Hkv,
        Sq, Skv, dp, *strides[0], *strides[1], *strides[2],
        int(causal), -1 if window is None else int(window), int(q_offset),
        1.0 / math.sqrt(Dh), DTYPES[q.dtype], build.stream()),
        "flash_attention")
    return out[..., :Dh] if dp != Dh else out, rows


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    mode: str = "auto"):
    """The output of ``flash_attention_fwd`` alone (no ``lse`` written)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, mode=mode)[0]


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        mode: str = "auto"):
    """The gradients (dq, dk, dv) of ``flash_attention``'s output against
    ``do``, from the forward's ``o`` and ``lse`` (``flash_attention_fwd``
    with ``lse=True``), each in its input's dtype.

    Three launches, each counted under ``flash_attention_bwd``: delta =
    rowsum(do o), then dk and dv (one block a kv tile, the query heads of
    its group summed in the block), then dq; the input type picks the
    design (``BWD_DESIGNS``).  The arguments are checked as the forward's
    are (a bfloat16 q, k or v that breaks a TMA precondition raises before
    any launch, and so does ``do``); q, k and v are read through their
    strides, ``o`` and ``do`` (autograd may hand over a strided one) are
    made contiguous.  A head dim that no kernel is built for runs
    zero-padded, as in the forward."""
    _check_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, q {tuple(q.shape)}")
    B, Sq, H, Dh = q.shape
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, expected {(B, H, Sq)} float32")
    if not build.use_kernel(mode, q):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           q_offset=q_offset)
    dp = _kernel_head_dim("flash_attention_bwd", Dh)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    q, k, v, o, do = _pad_head_dim(dp, q, k, v, o, do)
    _check_kernel_args("flash_attention_bwd", window, q, k, v, o, do)
    if lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse on {lse.device}, "
                         f"expected {q.device}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        strides = [_tma_strides(n, t) for n, t in (("q", q), ("k", k),
                                                    ("v", v), ("do", do))][:3]
    else:
        strides = [t.stride()[:3] for t in (q, k, v)]
    code, st = DTYPES[q.dtype], build.stream()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    lib = build.library()
    tail = (B, H, Hkv, Sq, Skv, dp, *strides[0], *strides[1], *strides[2],
            int(causal), -1 if window is None
            else int(window), int(q_offset), 1.0 / math.sqrt(Dh), code, st)
    build.LAUNCHES["flash_attention_bwd"] += 1
    build.check(lib.flash_attention_bwd_delta_launch(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, H, Sq, dp, code,
        st), "flash_attention_bwd (delta)")
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    build.LAUNCHES["flash_attention_bwd"] += 1
    build.check(lib.flash_attention_bwd_dkdv_launch(
        *inputs, dk.data_ptr(), dv.data_ptr(), *tail),
        "flash_attention_bwd (dk, dv)")
    build.LAUNCHES["flash_attention_bwd"] += 1
    build.check(lib.flash_attention_bwd_dq_launch(
        *inputs, dq.data_ptr(), *tail), "flash_attention_bwd (dq)")
    if dp != Dh:
        return dq[..., :Dh], dk[..., :Dh], dv[..., :Dh]
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward kernel with
    ``lse``, saved with q, k, v and the output; the backward kernels (or,
    on the CPU and under ``kernel_mode="torch"``, their plain versions).
    A kernel that fails to build or launch raises: nothing falls back."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, mode):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, mode=mode, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      mode=mode)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None, None
