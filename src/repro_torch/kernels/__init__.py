"""The port's kernel plane: hand-written CUDA kernels for sm_90a (``csrc/``),
their wrappers with plain PyTorch versions beside them (``ref``), and the
engine's entry points (``dispatch``).  ``build`` compiles and loads the
library at first use, never at import.

The names below are the reference's public ones (``repro.kernels``), but
for its JAX-only ``default_interpret``.  Two of them shadow the modules of
their kernels: import those modules by their full name (``from
repro_torch.kernels.flash_attention import ...``)."""
from .build import KERNEL_MODES
from .dispatch import (ROUND_PHASES, conv3x3_bias_relu, eval_head,
                       fused_phase_coverage, resolve_kernel_mode)
from .ops import (flash_attention, fused_coef_aggregate,
                  fused_coef_aggregate_pair, fused_edge_aggregate,
                  fused_edge_aggregate_batched, fused_mix_and_update,
                  fused_sgd_update)

__all__ = [
    "KERNEL_MODES", "ROUND_PHASES",
    "fused_phase_coverage", "resolve_kernel_mode",
    "conv3x3_bias_relu", "eval_head", "flash_attention",
    "fused_coef_aggregate", "fused_coef_aggregate_pair",
    "fused_edge_aggregate", "fused_edge_aggregate_batched",
    "fused_mix_and_update", "fused_sgd_update",
]
