"""The port's configurations: the paper's BHFL settings, and the LLM zoo's
architecture registry (``get_config(arch_id)`` / ``get_smoke(arch_id)``,
as ``repro.configs``).

The registry knows all ten architecture ids of the reference.  The port
runs the dense ones (the ``"attn"`` layer kind), the VLM and the
encoder-decoder (``"xattn"`` and ``"enc_attn"``), and those with
multi-head latent attention or mixture-of-experts layers (``"mla"``,
``"mla_moe"``, ``"attn_moe"``); the recurrent ones raise
``NotImplementedError`` until their layer kinds are ported (``ROADMAP.md``,
Queue 1).
"""
from __future__ import annotations

import dataclasses
import importlib

from .bhfl_cnn import DEFAULT, REDUCED, BHFLSetting

#: id -> module in this package, for the architectures the port runs
_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "qwen3-14b": "qwen3_14b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "minicpm3-4b": "minicpm3_4b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "grok-1-314b": "grok_1_314b",
}
#: the reference's other architectures, and the layer kinds they wait for
_NOT_PORTED = {
    "recurrentgemma-9b": "rglru",
    "mamba2-130m": "ssd",
}

ARCH_IDS = ("deepseek-7b", "seamless-m4t-large-v2", "minicpm3-4b",
            "deepseek-v2-lite-16b", "grok-1-314b", "recurrentgemma-9b",
            "qwen3-14b", "llama-3.2-vision-11b", "h2o-danube-1.8b",
            "mamba2-130m")


def _mod(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} needs {_NOT_PORTED[arch_id]}, which the port does "
            "not have yet (ROADMAP.md, Queue 1)")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    """Full (production) config for an architecture."""
    return _mod(arch_id).FULL


def get_smoke(arch_id: str):
    """Reduced same-family variant (2 layers, d_model 128)."""
    return _mod(arch_id).make_smoke()


def cut_depth(cfg, n_layers: int):
    """``cfg`` cut to ``n_layers`` decoder layers and, for a config with an
    encoder, as many encoder layers: one knob for both stacks."""
    enc = cfg.encoder and dataclasses.replace(cfg.encoder, n_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers, encoder=enc)


__all__ = ["ARCH_IDS", "BHFLSetting", "DEFAULT", "REDUCED", "cut_depth",
           "get_config", "get_smoke"]
