"""The paper's MNIST CNN (Sec. 6.1.5) on stacked per-device weights.

Port of the engine's path through ``repro.models.cnn``: two 3x3 SAME conv
blocks (``kernels.conv3x3``: implicit-GEMM kernels on the card), one 2x2
max-pool, one dense layer.  Layouts are the JAX package's: images ``[..., H, W, C]``, conv
weights ``[3, 3, Cin, Cout]``, dense ``[F, C]``.  The engine's functions
take a stacked model, every leaf with a leading device axis ``[D, ...]``,
and images ``[D, B, H, W, C]``; the devices' weights are independent.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch as _kd

from .spec import ParamSpec


def cnn_specs(image_hw: int = 28, channels: int = 1, n_classes: int = 10,
              c1: int = 32, c2: int = 64) -> dict:
    pooled = image_hw // 2  # one 2x2 max-pool after the convs (SAME padding)
    flat = pooled * pooled * c2
    return {
        "conv1": ParamSpec((3, 3, channels, c1)),
        "b1": ParamSpec((c1,), init="zeros"),
        "conv2": ParamSpec((3, 3, c1, c2)),
        "b2": ParamSpec((c2,), init="zeros"),
        "dense": ParamSpec((flat, n_classes)),
        "b3": ParamSpec((n_classes,), init="zeros"),
    }


def params_from_numpy(np_params: dict, device="cpu") -> dict:
    """Carry the JAX package's CNN parameters (numpy arrays, or anything
    ``np.asarray`` takes, in the JAX layouts) into the port's: float32
    tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in np_params.items()}


def stack_params(params: dict, *lead: int) -> dict:
    """Broadcast a model to ``[*lead, ...]`` stacked copies (contiguous)."""
    return {k: v.expand(tuple(lead) + tuple(v.shape)).contiguous()
            for k, v in params.items()}


def _pool_flatten(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool + flatten: [..., B, H, W, C] -> [..., B, F].
    ``amax`` splits the gradient evenly among tied maxima, as JAX's max
    reduction does."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // 2, 2, w // 2, 2, c).amax(dim=(-4, -2))
    return x.reshape(*lead, -1)


def cnn_features(params: dict, images: torch.Tensor,
                 kernel_mode: str = "auto") -> torch.Tensor:
    """Pooled, flattened features [D, B, F] of a stacked model on images
    [D, B, H, W, C], the conv blocks through ``dispatch.conv3x3_bias_relu``."""
    x = images
    for w, b in (("conv1", "b1"), ("conv2", "b2")):
        x = _kd.conv3x3_bias_relu(x, params[w], params[b], mode=kernel_mode)
    return _pool_flatten(x)


def cnn_logits(params: dict, images: torch.Tensor,
               kernel_mode: str = "auto") -> torch.Tensor:
    """Logits [D, B, n_classes].  The classifier is a plain ``bmm`` (XLA
    computes it outside any kernel in the JAX package)."""
    feats = cnn_features(params, images, kernel_mode)
    return torch.bmm(feats, params["dense"]) + params["b3"][:, None, :]


def cnn_loss(params: dict, images: torch.Tensor, labels: torch.Tensor,
             kernel_mode: str = "auto") -> torch.Tensor:
    """Per-device mean cross-entropy [D] (``repro.models.cnn.cnn_loss_fast``
    per device)."""
    logp = torch.log_softmax(cnn_logits(params, images, kernel_mode), dim=-1)
    picked = torch.take_along_dim(logp, labels.long()[..., None], dim=-1)
    return -picked[..., 0].mean(-1)


def cnn_accuracy(params: dict, images: torch.Tensor, labels: torch.Tensor,
                 kernel_mode: str = "auto") -> torch.Tensor:
    """Test accuracy of ONE model (unstacked leaves) on images [n, H, W, C]:
    the conv blocks, then the classifier head's correct-count
    (``dispatch.eval_head``) over the row count.  A 0-dim float32 tensor on
    the model's device."""
    stacked = {k: v[None] for k, v in params.items()}
    feats = cnn_features(stacked, images[None], kernel_mode)[0]
    count = _kd.eval_head(feats, params["dense"], params["b3"], labels,
                          mode=kernel_mode)
    return count.to(torch.float32) / labels.shape[0]
