"""Config registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` over the dense architectures and the hybrid
zamba2.  The other families' configs join with their models."""

from repro_torch.configs import (
    gemma2_9b, granite_3_8b, granite_8b, granite_34b, zamba2_7b)
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import LONG_CAPABLE, SHAPES, Shape, shapes_for

_MODULES = {
    "granite-8b": granite_8b,
    "granite-34b": granite_34b,
    "gemma2-9b": gemma2_9b,
    "granite-3-8b": granite_3_8b,
    "zamba2-7b": zamba2_7b,
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _MODULES[name].SMOKE_CONFIG
