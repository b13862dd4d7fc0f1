"""Model inputs beside the tokens (``repro.launch.inputs`` for the port).

Only ``memory_shape`` so far: the shape of the stubbed modality
frontend's output that cross-attention reads.  The reference's sharded
shape stand-ins (``input_specs``) are not ported (``ROADMAP.md``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.config import ArchConfig


def memory_shape(cfg: ArchConfig) -> Optional[tuple[int, int]]:
    """(frames, d_model) of the stubbed modality frontend, if any: the
    encoder's input frames (enc-dec), or the VLM's patch embeddings."""
    if cfg.encoder is not None:
        return cfg.encoder.n_frames, cfg.d_model
    if "xattn" in cfg.block_pattern:
        return cfg.n_image_tokens, cfg.d_model
    return None
