"""repro_torch.configs — the ported architectures as selectable configs.

The dense family (slice 1), mamba2 (the ssm family, slice 3) and
recurrentgemma (the hybrid family, slice 4) are ported; every other name
of the JAX package's registry raises, naming the ROADMAP item that ports
it.
"""
from __future__ import annotations

import importlib
from typing import List

_REGISTRY = {
    "qwen1.5-0.5b": "qwen15_05b",
    "tinyllama-1.1b": "tinyllama_11b",
    "smollm-360m": "smollm_360m",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "mistral-large-123b": "mistral_large_123b",
}
_UNPORTED = {
    "qwen2-moe-a2.7b": "A9",
    "mixtral-8x22b": "A9",
    "internvl2-76b": "A11",
    "whisper-medium": "A11",
}


def list_configs() -> List[str]:
    return list(_REGISTRY)


# Module names double as arch aliases ("qwen15_05b" == "qwen1.5-0.5b").
_ALIASES = {mod: disp for disp, mod in _REGISTRY.items()}


def get_config(name: str, smoke: bool = False):
    name = _ALIASES.get(name, name)
    if name in _UNPORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP {_UNPORTED[name]})"
        )
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list(_REGISTRY)}")
    mod = importlib.import_module(f".{_REGISTRY[name]}", __package__)
    return mod.SMOKE if smoke else mod.FULL
