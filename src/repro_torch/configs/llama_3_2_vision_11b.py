"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  Every 5th layer is
a gated cross-attention layer against vision-projector patch embeddings
(8 of 40).  The ViT encoder + projector are a stub, as in the reference:
the caller hands in precomputed patch embeddings [B, n_image_tokens, D].
"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    block_pattern=("attn", "attn", "attn", "attn", "xattn"),
    n_image_tokens=1601,
    source="Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision]",
    clients_per_pod=16,
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="llama-vision-smoke", n_layers=5, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, param_dtype="float32",
        n_image_tokens=16)
