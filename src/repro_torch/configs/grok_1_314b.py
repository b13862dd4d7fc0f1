"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.

At 314B parameters one FL client is an entire pod (clients_per_pod=1):
the client's weights are FSDP+TP sharded over all 256 in-pod chips.
"""
from repro_torch.models.config import ArchConfig, MoEConfig

FULL = ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared=0, d_expert=32768),
    block_pattern=("attn_moe",),
    source="Grok-1 [hf:xai-org/grok-1]",
    clients_per_pod=1,
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="grok-1-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, param_dtype="float32",
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=256,
                      capacity_factor=16.0))  # drop-free for exactness tests
