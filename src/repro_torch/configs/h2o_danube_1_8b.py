"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding window 4096.
Sub-quadratic (windowed attention) → runs long_500k.
"""
from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,
    block_pattern=("attn",),
    subquadratic=True,
    source="H2O-Danube-1.8B [arXiv:2401.16818]",
    clients_per_pod=16,
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="danube-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, sliding_window=16,
        param_dtype="float32")
