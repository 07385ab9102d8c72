"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "llama4-maverick-400b-a17b",
    "deepseek-v2-236b",
    "hymba-1.5b",
    "mistral-large-123b",
    "phi4-mini-3.8b",
    "gemma-7b",
    "qwen2-0.5b",
    "chameleon-34b",
    "falcon-mamba-7b",
    "whisper-small",
)

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    if arch == "elasticity":
        raise ValueError("elasticity config is solver-side: use "
                         "repro_torch.configs.elasticity")
    mod = importlib.import_module(_MODULES[arch])
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
