"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954].

30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="deepseek-7b",
    arch_type="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    rope_theta=10000.0,
    block_pattern=("attn",),
    source="DeepSeek LLM 7B [arXiv:2401.02954]",
    clients_per_pod=16,
)


def make_smoke() -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests."""
    import dataclasses
    return dataclasses.replace(
        FULL, name="deepseek-7b-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, vocab=512, param_dtype="float32")
