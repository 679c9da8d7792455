"""Architecture registry of the PyTorch port.

Only the architectures whose model families are ported are listed; the
others are queued in ROADMAP.md. Each module exports CONFIG (the full
config) and SMOKE (a reduced same-family config for CPU tests).
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    FrontendConfig,
    ModelConfig,
    MoEConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    shape_applicable,
)

ARCH_IDS = [
    "relic_tiny",      # paper-scale end-to-end example config
    "rwkv6_1p6b",      # ssm family: RWKV-6, wkv6 kernel
    "zamba2_1p2b",     # hybrid family: Mamba-2 + shared attention, ssd kernel
]

_ALIASES = {
    "whisper-large-v3": "whisper_large_v3",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "arctic-480b": "arctic_480b",
    "granite-8b": "granite_8b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "llama3-405b": "llama3_405b",
    "qwen3-14b": "qwen3_14b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "zamba2-1.2b": "zamba2_1p2b",
    "paligemma-3b": "paligemma_3b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    arch = canonical(name)
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to repro_torch yet "
            f"(ported: {ARCH_IDS}); see ROADMAP.md")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.SMOKE if smoke else mod.CONFIG
