"""The classifier head's correct-count (logits -> argmax -> compare -> count)
on the CUDA kernel of ``csrc/eval_head.cu``; the logits are never stored.

Port of ``repro.kernels.eval_head``.  Plain version: ``ref.eval_head_ref``.
"""
from __future__ import annotations

import torch

from . import build, ref

#: features of a slice — the value in csrc/eval_head.cu, which sizes the
#: partial-logit workspace
FEATURES_PER_SLICE = 512


def eval_head(feats, wmat, bias, labels, mode: str = "auto"):
    """feats [M, F], wmat [F, C], bias [C], labels [M] (a label of -1 never
    counts) -> 0-dim int64 count on the device.  Any number of classes."""
    if not build.use_kernel(mode, feats):
        return ref.eval_head_ref(feats, wmat, bias, labels)
    M, F = feats.shape
    C = wmat.shape[1]
    dev, f32 = feats.device, torch.float32
    if labels.dtype is not torch.int32 or not labels.is_contiguous():
        labels = labels.to(torch.int32).contiguous()
    if not (feats.dtype is f32 and wmat.dtype is f32 and bias.dtype is f32):
        raise TypeError(f"eval_head: float32 feats, wmat and bias, got "
                        f"{feats.dtype}, {wmat.dtype}, {bias.dtype}")
    if not (wmat.shape == (F, C) and bias.shape == (C,)
            and labels.shape == (M,) and feats.is_contiguous()
            and wmat.is_contiguous() and bias.is_contiguous()
            and wmat.device == dev and bias.device == dev
            and labels.device == dev):
        raise ValueError(f"eval_head: contiguous feats [M, F], wmat [F, C], "
                         f"bias [C], labels [M] on {dev}, got "
                         f"{tuple(feats.shape)}, {tuple(wmat.shape)}, "
                         f"{tuple(bias.shape)}, {tuple(labels.shape)} on "
                         f"{wmat.device}, {bias.device}, {labels.device}")
    slices = max(1, -(-F // FEATURES_PER_SLICE))
    part = torch.empty((slices, M, C), device=dev, dtype=f32)
    count = torch.empty((), device=dev, dtype=torch.int64)
    build.LAUNCHES["eval_head"] += 1
    with build.on_device(feats):
        build.check(build.library().eval_head_launch(
            feats.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
            labels.data_ptr(), part.data_ptr(), count.data_ptr(), M, F, C,
            build.stream()), "eval_head")
    return count
