"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="qwen3-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    qk_norm=True,
    head_dim=128,
    rope_theta=1000000.0,
    block_pattern=("attn",),
    source="Qwen3-14B [hf:Qwen/Qwen3-8B]",
    clients_per_pod=16,
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="qwen3-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, param_dtype="float32")
