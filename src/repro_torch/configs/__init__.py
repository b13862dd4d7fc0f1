"""The port's configurations: the paper's BHFL settings, and the LLM zoo's
architecture registry (``get_config(arch_id)`` / ``get_smoke(arch_id)``,
as ``repro.configs``).

The registry knows all ten architecture ids of the reference, and the
port runs every one: dense, sliding-window, the VLM and the
encoder-decoder, multi-head latent attention and mixture-of-experts, and
the recurrent ones (``"rec"``, RG-LRU, with a tail; ``"ssd"``, Mamba-2).
"""
from __future__ import annotations

import dataclasses
import importlib

from .bhfl_cnn import DEFAULT, REDUCED, BHFLSetting

#: id -> module in this package
_MODULES = {
    "deepseek-7b": "deepseek_7b",
    "qwen3-14b": "qwen3_14b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "minicpm3-4b": "minicpm3_4b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "grok-1-314b": "grok_1_314b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mamba2-130m": "mamba2_130m",
}

ARCH_IDS = ("deepseek-7b", "seamless-m4t-large-v2", "minicpm3-4b",
            "deepseek-v2-lite-16b", "grok-1-314b", "recurrentgemma-9b",
            "qwen3-14b", "llama-3.2-vision-11b", "h2o-danube-1.8b",
            "mamba2-130m")


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    """Full (production) config for an architecture."""
    return _mod(arch_id).FULL


def get_smoke(arch_id: str):
    """Reduced same-family variant (2 layers, d_model 128)."""
    return _mod(arch_id).make_smoke()


def all_configs() -> dict:
    """Every architecture's full config, by id (``ARCH_IDS`` order)."""
    return {a: get_config(a) for a in ARCH_IDS}


def cut_depth(cfg, n_layers: int):
    """``cfg`` cut to ``n_layers`` decoder layers and, for a config with an
    encoder, as many encoder layers: one knob for both stacks.  The decoder
    keeps whole units and its tail: a count that is not ``u`` units of
    ``block_pattern`` (u >= 1) plus ``tail_pattern`` raises ``ValueError``
    naming the counts that are (recurrentgemma: 3u + 2)."""
    unit, tail = len(cfg.block_pattern), len(cfg.tail_pattern)
    if n_layers < unit + tail or (n_layers - tail) % unit:
        valid = ", ".join(str(u * unit + tail) for u in range(1, 4))
        raise ValueError(
            f"{cfg.name}: {n_layers} layers; whole units of "
            f"{cfg.block_pattern} and the tail {cfg.tail_pattern} give "
            f"{unit}u + {tail} layers, u >= 1 ({valid}, ...)")
    enc = cfg.encoder and dataclasses.replace(cfg.encoder, n_layers=n_layers)
    return dataclasses.replace(cfg, n_layers=n_layers, encoder=enc)


__all__ = ["ARCH_IDS", "BHFLSetting", "DEFAULT", "REDUCED", "all_configs",
           "cut_depth", "get_config", "get_smoke"]
