"""The paper's MNIST CNN (Sec. 6.1.5) on stacked per-device weights.

Port of the engine's path through ``repro.models.cnn``: two 3x3 SAME conv
blocks (``kernels.conv3x3``: implicit-GEMM kernels on the card), one 2x2
max-pool, one dense layer.  Layouts are the JAX package's: images ``[..., H, W, C]``, conv
weights ``[3, 3, Cin, Cout]``, dense ``[F, C]``.  The engine's functions
take a stacked model, every leaf with a leading device axis ``[D, ...]``,
and images ``[D, B, H, W, C]``; the devices' weights are independent.

The ``*_shifted`` functions are ``run_legacy``'s model: the reference's
``cnn_apply``/``cnn_loss``/``cnn_accuracy``, whose conv is the sum of nine
shifted matmuls (``conv3x3_same_shifted``), in plain float32 PyTorch.
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
        "conv1": ParamSpec((3, 3, channels, c1), (None, None, None, None)),
        "b1": ParamSpec((c1,), (None,), init="zeros"),
        "conv2": ParamSpec((3, 3, c1, c2), (None, None, None, None)),
        "b2": ParamSpec((c2,), (None,), init="zeros"),
        "dense": ParamSpec((flat, n_classes), (None, None)),
        "b3": ParamSpec((n_classes,), (None,), init="zeros"),
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


def cnn_accuracy_many(params: dict, images: torch.Tensor,
                      labels: torch.Tensor, kernel_mode: str = "auto"
                      ) -> torch.Tensor:
    """Test accuracy of P models (stacked leaves ``[P, ...]``), model p on
    its own images ``[P, n, H, W, C]`` and labels ``[P, n]``: the conv
    blocks of all P at once, then each model's classifier head
    correct-count (``dispatch.eval_head``) over the row count.  A float32
    ``[P]`` tensor on the models' device."""
    feats = cnn_features(params, images, kernel_mode)
    counts = [_kd.eval_head(feats[p], params["dense"][p], params["b3"][p],
                            labels[p], mode=kernel_mode)
              for p in range(feats.shape[0])]
    return torch.stack([c.to(torch.float32) / labels.shape[1]
                        for c in counts])


def cnn_accuracy(params: dict, images: torch.Tensor, labels: torch.Tensor,
                 kernel_mode: str = "auto") -> torch.Tensor:
    """Test accuracy of ONE model (unstacked leaves) on images [n, H, W, C]
    (``cnn_accuracy_many`` of one model).  A 0-dim float32 tensor on the
    model's device."""
    return cnn_accuracy_many({k: v[None] for k, v in params.items()},
                             images[None], labels[None], kernel_mode)[0]


# ------------------------------------------------ the shifted-sum model
def conv3x3_same_shifted(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv as the sum of nine shifted matmuls, the reference's
    ``_conv3x3_same``: x ``[D, B, H, W, Cin]``, w ``[D, 3, 3, Cin, Cout]``
    -> ``[D, B, H, W, Cout]``, the terms added in (i, j) order."""
    h, wd = x.shape[-3], x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            term = torch.einsum("dbhwc,dco->dbhwo",
                                xp[:, :, i:i + h, j:j + wd, :], w[:, i, j])
            out = term if out is None else out + term
    return out


def cnn_logits_shifted(params: dict, images: torch.Tensor) -> torch.Tensor:
    """Logits ``[D, B, n_classes]`` of a stacked model with the shifted-sum
    conv (the reference's ``cnn_apply`` per device)."""
    x = images
    for w, b in (("conv1", "b1"), ("conv2", "b2")):
        x = torch.relu(conv3x3_same_shifted(x, params[w])
                       + params[b][:, None, None, None, :])
    feats = _pool_flatten(x)
    return torch.bmm(feats, params["dense"]) + params["b3"][:, None, :]


def cnn_loss_shifted(params: dict, images: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Per-device mean cross-entropy ``[D]`` with the shifted-sum conv (the
    reference's ``cnn_loss`` per device)."""
    logp = torch.log_softmax(cnn_logits_shifted(params, images), dim=-1)
    picked = torch.take_along_dim(logp, labels.long()[..., None], dim=-1)
    return -picked[..., 0].mean(-1)


def cnn_accuracy_shifted(params: dict, images: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Test accuracy of ONE model (unstacked leaves) on images
    ``[n, H, W, C]`` with the shifted-sum conv (the reference's
    ``cnn_accuracy``): a 0-dim float32 tensor on the model's device."""
    logits = cnn_logits_shifted({k: v[None] for k, v in params.items()},
                                images[None])[0]
    return (logits.argmax(-1) == labels.long()).to(torch.float32).mean()
