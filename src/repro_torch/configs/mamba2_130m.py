"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768 (attention-free) d_ff=0 vocab=50280, ssm_state=128.
Sub-quadratic (O(1)-state decode) → runs long_500k.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

FULL = ArchConfig(
    name="mamba2-130m",
    arch_type="ssm",
    n_layers=24,
    d_model=768,
    n_heads=1,           # unused by the SSD mixer (heads come from SSMConfig)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    block_pattern=("ssd",),
    tie_embeddings=True,
    subquadratic=True,
    source="Mamba2-130M [arXiv:2405.21060]",
    clients_per_pod=16,
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="mamba2-smoke", n_layers=2, d_model=128, vocab=512,
        param_dtype="float32",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16))
