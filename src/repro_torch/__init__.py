"""PyTorch/CUDA port of the BHFL reproduction (``repro``), for the H100.

Mirrors the JAX package's layout (``configs``, ``core``, ``data``,
``models``, ``optim``, ``kernels``, ``fl``) and imports nothing of it.
Entry point: ``repro_torch.fl.BHFLSimulator(...).run()``.

The port computes in full float32: TF32 matmuls and convolutions are
switched off here, so its plain PyTorch versions on the card round like
its hand-written FP32 kernels.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
