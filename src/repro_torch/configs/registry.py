"""The paper's own CNN workloads by name (`repro.configs.registry`'s
`paper_cnn_configs`; the LM architectures are not ported yet)."""
from __future__ import annotations

from typing import Dict

from .base import CNNConfig


def paper_cnn_configs() -> Dict[str, CNNConfig]:
    from repro_torch.models.cnn import SEGNET_LAYERS, VGG11_LAYERS
    return {
        "vgg11": CNNConfig(name="vgg11", layers=VGG11_LAYERS, n_classes=10),
        "resnet18": CNNConfig(name="resnet18", layers=(), n_classes=10),
        "segnet": CNNConfig(name="segnet", layers=SEGNET_LAYERS, img=64,
                            n_classes=2),
    }
