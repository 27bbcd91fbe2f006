"""Config registry: --arch <id> resolution (the port's configs so far)."""
from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs import (deepseek_v2_lite_16b, gemma3_4b,
                                 internlm2_1_8b, mamba2_370m,
                                 recurrentgemma_9b)

_REGISTRY = {m.CONFIG.name: m for m in (gemma3_4b, internlm2_1_8b,
                                        deepseek_v2_lite_16b, mamba2_370m,
                                        recurrentgemma_9b)}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    mod = _REGISTRY[name]
    return mod.SMOKE if smoke else mod.CONFIG
