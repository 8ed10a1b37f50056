"""Architecture registry: arch id -> (full config, reduced smoke config),
and the paper's own workloads by name (`repro.configs.registry`'s
`get_config`, `get_reduced`, `get_shape`, `ARCH_IDS`, `all_cells`,
`paper_cnn_configs` and `PAPER_TRANSFORMERS`).

All ten LM architectures of `repro` are registered as data. The models
build the attention family (dense, MoE, encoder-decoder, VLM);
`models/lm.py::layer_pattern` refuses the hybrid (Mamba) and xLSTM
blocks of jamba and xlstm until `models/ssm.py` is ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .base import CNNConfig, LMConfig, SHAPES, ShapeSpec
from . import (jamba_1_5_large_398b, internlm2_20b, mistral_large_123b,
               mixtral_8x22b, phi_3_vision_4_2b, qwen2_moe_a2_7b, qwen3_4b,
               tinyllama_1_1b, whisper_medium, xlstm_350m)

_LM_MODULES = {
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b,
    "mixtral-8x22b": mixtral_8x22b,
    "whisper-medium": whisper_medium,
    "internlm2-20b": internlm2_20b,
    "tinyllama-1.1b": tinyllama_1_1b,
    "mistral-large-123b": mistral_large_123b,
    "qwen3-4b": qwen3_4b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
    "xlstm-350m": xlstm_350m,
}

ARCH_IDS = tuple(_LM_MODULES)


def get_config(arch: str) -> LMConfig:
    return _LM_MODULES[arch].CONFIG


def get_reduced(arch: str) -> LMConfig:
    return _LM_MODULES[arch].REDUCED


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def all_cells() -> Tuple[Tuple[str, str], ...]:
    """The 40 (arch x shape) cells."""
    return tuple((a, s.name) for a in ARCH_IDS for s in SHAPES)


# ----------------------------------------------------- paper's own models
def paper_cnn_configs() -> Dict[str, CNNConfig]:
    from repro_torch.models.cnn import SEGNET_LAYERS, VGG11_LAYERS
    return {
        "vgg11": CNNConfig(name="vgg11", layers=VGG11_LAYERS, n_classes=10),
        "resnet18": CNNConfig(name="resnet18", layers=(), n_classes=10),
        "segnet": CNNConfig(name="segnet", layers=SEGNET_LAYERS, img=64,
                            n_classes=2),
    }


PAPER_TRANSFORMERS = {
    "spikingformer-4-256": dict(depth=4, dim=256, n_classes=10),
    "spikingformer-2-512": dict(depth=2, dim=512, n_classes=100),
}
