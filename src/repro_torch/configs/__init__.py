"""Architecture registry: the ten assigned configs + the paper-scale tiny LM.

Each module exports CONFIG (the exact assigned full config) and SMOKE (a
reduced same-family config for CPU smoke tests). Full configs are only ever
instantiated abstractly (dry-run via ShapeDtypeStruct); SMOKE configs run.
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
    "whisper_large_v3",
    "llama4_maverick_400b_a17b",
    "arctic_480b",
    "granite_8b",
    "phi3_mini_3p8b",
    "llama3_405b",
    "qwen3_14b",
    "rwkv6_1p6b",
    "zamba2_1p2b",
    "paligemma_3b",
    "relic_tiny",      # paper-scale end-to-end example config
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
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCH_IDS if a != "relic_tiny"}
