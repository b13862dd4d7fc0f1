"""Architecture and workload configuration dataclasses (``repro.models.config``
for the port).

Plain copies of the reference's dataclasses; ``torch_param_dtype`` takes
the place of ``jnp_param_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""
    q_lora_rank: Optional[int]     # None = direct q projection
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0              # shared (always-on) experts
    d_expert: Optional[int] = None  # per-expert ffn width (default = d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent block."""
    lru_width: Optional[int] = None   # default = d_model
    d_conv: int = 4
    c_constant: float = 8.0


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Second (encoder) stack for enc-dec architectures."""
    n_layers: int
    n_frames: int = 1500            # stubbed modality-frontend output length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # repeating block pattern, e.g. ("attn","mlp") per layer family:
    #   dense: unit = ("attn",); hybrid rg: unit = ("rec","rec","attn")
    #   vlm:   unit = ("attn","attn","attn","attn","xattn")
    block_pattern: tuple[str, ...] = ("attn",)
    tail_pattern: tuple[str, ...] = ()   # non-repeating trailing layers
    encoder: Optional[EncoderConfig] = None
    n_image_tokens: int = 1600       # vlm stub: patch-embedding count
    source: str = ""                 # citation
    # ---- distribution knobs ----
    clients_per_pod: int = 16        # FL client groups per pod (Layout A) or 1 (Layout C)
    param_dtype: str = "bfloat16"
    # long-context support: archs with sub-quadratic paths run long_500k
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_units(self) -> int:
        if not self.block_pattern:
            return 0
        n = (self.n_layers - len(self.tail_pattern)) // len(self.block_pattern)
        assert n * len(self.block_pattern) + len(self.tail_pattern) == self.n_layers, \
            (self.name, self.n_layers, self.block_pattern, self.tail_pattern)
        return n

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float64": torch.float64}[self.param_dtype]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")
INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
