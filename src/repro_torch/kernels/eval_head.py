"""The classifier head's correct-count (logits -> argmax -> compare -> count)
on the CUDA kernel of ``csrc/eval_head.cu``; the logits are never stored.

Port of ``repro.kernels.eval_head``.  Plain version: ``ref.eval_head_ref``.
"""
from __future__ import annotations

import torch

from . import build, ref

#: rows per block of the kernel (one warp each) and the most classes it
#: keeps in registers — the values in csrc/eval_head.cu
ROWS_PER_BLOCK = 8
MAX_CLASSES = 16


def eval_head(feats, wmat, bias, labels, mode: str = "auto"):
    """feats [M, F], wmat [F, C], bias [C], labels [M] (a label of -1 never
    counts) -> 0-dim int64 count on the device."""
    if not build.use_kernel(mode, feats):
        return ref.eval_head_ref(feats, wmat, bias, labels)
    M, F = feats.shape
    C = wmat.shape[1]
    if C > MAX_CLASSES:
        raise ValueError(f"eval_head: {C} classes, the kernel holds at most "
                         f"{MAX_CLASSES}")
    build.expect(feats, "feats", (M, F))
    build.expect(wmat, "wmat", (F, C), device=feats.device)
    build.expect(bias, "bias", (C,), device=feats.device)
    labels = labels.to(torch.int32).contiguous()
    build.expect(labels, "labels", (M,), dtype=torch.int32,
                 device=feats.device)
    counts = torch.empty((-(-M // ROWS_PER_BLOCK),), device=feats.device,
                         dtype=torch.int32)
    build.LAUNCHES["eval_head"] += 1
    build.check(build.library().eval_head_launch(
        feats.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
        labels.data_ptr(), counts.data_ptr(), M, F, C, build.stream()),
        "eval_head")
    return counts.sum()
