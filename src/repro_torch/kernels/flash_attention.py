"""Flash attention over GQA heads on the CUDA kernels of
``csrc/flash_attention.cu``: ``softmax(q kᵀ / sqrt(Dh)) v`` with causal and
sliding-window masks, the ``[Sq, Skv]`` logits never stored.

Port of ``repro.kernels.flash_attention.flash_attention_1h`` with the
batch, kv-head and group ``vmap`` of ``repro.kernels.ops.flash_attention``
as the kernel's grid axes.  The input type picks the kernel: bfloat16 runs
on tensor cores (``wgmma``, operands loaded by TMA), float32 on FP32 FMA
(``DESIGNS``).  Plain version: ``ref.flash_attention_ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build, ref

#: the head dims the kernel is built for (csrc/flash_attention.cu)
HEAD_DIMS = (32, 64, 80, 128)
#: input types and the launcher's code for each
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the design each input type launches, by its kernel's name
DESIGNS = {torch.float32: "flash_attention_kernel (FP32 FMA)",
           torch.bfloat16: "flash_attention_wgmma_kernel (bf16 wgmma, TMA "
                           "kv ring)"}


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


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0,
                    mode: str = "auto"):
    """GQA flash attention: q [B, Sq, H, Dh]; k, v [B, Skv, Hkv, Dh], H a
    multiple of Hkv -> [B, Sq, H, Dh] in ``v.dtype`` (scale 1/sqrt(Dh)).

    The query heads are (Hkv, G) in that order, as the reference's reshape
    to [B, Sq, Hkv, G, Dh]: head h reads kv head ``h // G``.  Query row i
    sits at absolute position ``q_offset + i``.  The kernel reads the
    operands through their strides (the head dim contiguous) and takes
    float32 or bfloat16, all three alike; a bfloat16 operand whose address
    or strides break a TMA precondition raises before any launch."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not build.use_kernel(mode, q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    B, Sq, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh}; the kernel is "
                         f"built for {HEAD_DIMS}")
    if q.dtype not in DTYPES or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v in one of {list(DTYPES)}"
                        f", got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, "
                             f"expected {q.device}")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if B > 65535 or H > 65535:           # the grid's y and z limits
        raise ValueError(f"flash_attention: batch {B} or heads {H} over "
                         "65535")
    if q.dtype == torch.bfloat16:
        strides = [_tma_strides(n, t) for n, t in (("q", q), ("k", k),
                                                    ("v", v))]
    else:
        strides = [t.stride()[:3] for t in (q, k, v)]
    out = torch.empty((B, Sq, H, Dh), dtype=v.dtype, device=q.device)
    build.LAUNCHES["flash_attention"] += 1
    build.check(build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv,
        Sq, Skv, Dh, *strides[0], *strides[1], *strides[2],
        int(causal), -1 if window is None else int(window), int(q_offset),
        DTYPES[q.dtype], build.stream()), "flash_attention")
    return out

