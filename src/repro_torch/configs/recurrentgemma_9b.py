"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000.
Griffin pattern: (recurrent, recurrent, local-attention) repeated; 38 layers
= 12 full units + a trailing (rec, rec) tail.  Local attention window 2048.
Sub-quadratic → runs long_500k.
"""
from repro_torch.models.config import ArchConfig, RGLRUConfig

FULL = ArchConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    sliding_window=2048,
    rglru=RGLRUConfig(lru_width=4096),
    block_pattern=("rec", "rec", "attn"),
    tail_pattern=("rec", "rec"),
    tie_embeddings=True,
    subquadratic=True,
    source="RecurrentGemma-9B [arXiv:2402.19427]",
    clients_per_pod=16,
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="recurrentgemma-smoke", n_layers=5, d_model=128, n_heads=4,
        n_kv_heads=1, d_ff=256, vocab=512, param_dtype="float32",
        sliding_window=16, rglru=RGLRUConfig(lru_width=128))
