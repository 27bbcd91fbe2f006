"""Config registry: --arch <id> resolution."""
from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, \
    LONG_CONTEXT_OK  # noqa: F401
from repro_torch.configs import (
    gemma3_4b, internlm2_1_8b, deepseek_7b, qwen2_7b,
    deepseek_v2_lite_16b, deepseek_v2_236b, whisper_medium, mamba2_370m,
    qwen2_vl_2b, recurrentgemma_9b,
)

_REGISTRY = {
    m.CONFIG.name: m for m in (
        gemma3_4b, internlm2_1_8b, deepseek_7b, qwen2_7b,
        deepseek_v2_lite_16b, deepseek_v2_236b, whisper_medium,
        mamba2_370m, qwen2_vl_2b, recurrentgemma_9b)
}

ARCH_NAMES = tuple(_REGISTRY)


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    mod = _REGISTRY[name]
    return mod.SMOKE if smoke else mod.CONFIG
