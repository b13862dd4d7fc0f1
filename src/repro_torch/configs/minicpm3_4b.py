"""minicpm3-4b [dense] — MLA [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448.
MLA dims from the model card: q_lora_rank=768, kv_lora_rank=256,
qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64.
"""
from repro_torch.models.config import ArchConfig, MLAConfig

FULL = ArchConfig(
    name="minicpm3-4b",
    arch_type="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    block_pattern=("mla",),
    tie_embeddings=True,
    source="MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]",
    clients_per_pod=16,
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="minicpm3-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512, param_dtype="float32",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16))
