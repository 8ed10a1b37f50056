"""Architecture registry: arch id -> (full config, reduced smoke config),
and the paper's own CNN workloads by name (`repro.configs.registry`'s
`get_config`, `get_reduced`, `get_shape`, `ARCH_IDS` and
`paper_cnn_configs`).

Only `tinyllama-1.1b` is registered so far; the other nine LM
architectures of `repro` wait for ROADMAP queue 1 item 5, and asking for
one raises instead of handing back another config.
"""
from __future__ import annotations

from typing import Dict

from .base import CNNConfig, LMConfig, SHAPES, ShapeSpec
from . import tinyllama_1_1b

_LM_MODULES = {
    "tinyllama-1.1b": tinyllama_1_1b,
}

ARCH_IDS = tuple(_LM_MODULES)


def _module(arch: str):
    try:
        return _LM_MODULES[arch]
    except KeyError:
        raise KeyError(
            f"arch {arch!r} is not ported: the port registers {ARCH_IDS}; "
            f"the other LM architectures wait for ROADMAP queue 1 item 5"
        ) from None


def get_config(arch: str) -> LMConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> LMConfig:
    return _module(arch).REDUCED


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


# ----------------------------------------------------- paper's own models
def paper_cnn_configs() -> Dict[str, CNNConfig]:
    from repro_torch.models.cnn import SEGNET_LAYERS, VGG11_LAYERS
    return {
        "vgg11": CNNConfig(name="vgg11", layers=VGG11_LAYERS, n_classes=10),
        "resnet18": CNNConfig(name="resnet18", layers=(), n_classes=10),
        "segnet": CNNConfig(name="segnet", layers=SEGNET_LAYERS, img=64,
                            n_classes=2),
    }
