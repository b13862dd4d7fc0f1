"""deepseek-v2-lite-16b [moe] — MLA + MoE [arXiv:2405.04434].

27L d_model=2048 16H (GQA kv=16) d_ff=1408 (per-expert) vocab=102400,
MoE 64 routed experts top-6 + 2 shared, MLA kv_lora_rank=512.

The assignment line reads "MoE 64e top-6 ... 2 shared+160 routed top-6";
160 routed is full DeepSeek-V2 — we follow the V2-*Lite* spec the
architecture id names: 64 routed experts.
MLA in Lite has no q compression (q_lora_rank=None), qk_nope=128, rope=64,
v_head_dim=128.
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

FULL = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mla=MLAConfig(q_lora_rank=None, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408),
    block_pattern=("mla_moe",),
    source="DeepSeek-V2-Lite [arXiv:2405.04434]",
    clients_per_pod=16,   # must divide the 16-wide data axis
)


def make_smoke() -> ArchConfig:
    import dataclasses
    return dataclasses.replace(
        FULL, name="dsv2-lite-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=512, param_dtype="float32",
        mla=MLAConfig(q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=64,
                      capacity_factor=16.0))  # drop-free for exactness tests
