"""Config registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` over the reference's architectures, in its
order."""

from repro_torch.configs import (
    gemma2_9b, granite_3_8b, granite_8b, granite_34b, moonshot_v1_16b,
    musicgen_large, pixtral_12b, qwen3_moe_30b, xlstm_1_3b, zamba2_7b)
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import LONG_CAPABLE, SHAPES, Shape, shapes_for

_MODULES = {
    "musicgen-large": musicgen_large,
    "granite-8b": granite_8b,
    "granite-34b": granite_34b,
    "gemma2-9b": gemma2_9b,
    "granite-3-8b": granite_3_8b,
    "zamba2-7b": zamba2_7b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b,
    "qwen3-moe-30b-a3b": qwen3_moe_30b,
    "xlstm-1.3b": xlstm_1_3b,
    "pixtral-12b": pixtral_12b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _MODULES[name].SMOKE_CONFIG
