"""Training step of the paper's CNN workloads: spiking VGG11 and ResNet18
(classification, softmax cross-entropy) and SegNet (per-pixel, the lane
pixels weighted up), as `examples/segmentation.py` of the reference trains
SegNet with `jax.value_and_grad` and AdamW.

A step is `torch.autograd` over the float leaves of the param tree (VGG11's
`None` pooling slots and ResNet18's `int` block strides are not trained),
then `optim.adamw.update` in place. The forward resolves its ops through
the registry's automatic routes, as inference does: on the card the fires
run the counts kernel with its residual (row 5) and the surrogate backward
(row 3), `econv` the pipelined CSR kernel (row 12) and SegNet's `tconv`
the predicated kernel (row 10); the convs' backward replays the dense conv
in full fp32 (`vjp="ref"`), and max-pooling sends each window's gradient to
its first maximum. Training keeps dense spike payloads (packed words carry
no gradient).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import CNNConfig, SpikingConfig
from repro_torch.configs.registry import paper_cnn_configs
from repro_torch.data.synthetic import class_images, seg_batch
from repro_torch.models import cnn
from repro_torch.optim import adamw

MODELS = ("vgg11", "resnet18", "segnet")
# Lane pixels are rare: the segmentation loss weights them up.
LANE_WEIGHT = 4.0


def config(name: str, t_steps: int = 4, lif_vth: float = 1.0,
           img: Optional[int] = None) -> CNNConfig:
    """The paper's config of `name` at `t_steps` and `lif_vth` (and `img`,
    where given)."""
    cfg = paper_cnn_configs()[name]
    return dataclasses.replace(
        cfg, img=cfg.img if img is None else img,
        spiking=SpikingConfig(t_steps=t_steps, lif_vth=lif_vth))


def float_leaves(params) -> List[torch.Tensor]:
    """The trained tensors of a CNN param tree, in `adamw.leaves` order."""
    return [x for x in adamw.leaves(params) if isinstance(x, torch.Tensor)]


def init_params(name: str, cfg: CNNConfig, seed: int = 0,
                device="cuda") -> dict:
    """Seeded params of `name` on `device`, every float leaf an autograd
    leaf."""
    params = getattr(cnn, f"{name}_init")(
        cfg, generator=torch.Generator().manual_seed(seed),
        device=resolve_device(device))
    for leaf in float_leaves(params):
        leaf.requires_grad_(True)
    return params


def batch(name: str, cfg: CNNConfig, seed: int, step: int, size: int,
          device="cuda") -> Dict[str, torch.Tensor]:
    """A synthetic batch on `device`: `class_images` ("image", "label")
    for the classifiers, `seg_batch` ("image", "mask") for SegNet."""
    dev = resolve_device(device)
    if name == "segnet":
        b = seg_batch(seed, 0, step, size, img=cfg.img)
        return {"image": torch.from_numpy(b["image"]).to(dev),
                "mask": torch.from_numpy(b["mask"]).long().to(dev)}
    b = class_images(seed, 0, step, size, img=cfg.img,
                     n_classes=cfg.n_classes)
    return {"image": torch.from_numpy(b["image"]).to(dev),
            "label": torch.from_numpy(b["label"]).long().to(dev)}


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy in f32."""
    return torch.nn.functional.cross_entropy(logits.float(), labels)


def segmentation_loss(logits: torch.Tensor,
                      masks: torch.Tensor) -> torch.Tensor:
    """Per-pixel cross-entropy in f32 over (B, H, W, 2) logits, each lane
    pixel (mask 1) weighted by LANE_WEIGHT, averaged over every pixel."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, masks[..., None]).squeeze(-1)
    w = torch.where(masks == 1, LANE_WEIGHT, 1.0)
    return -(w * picked).mean()


def loss_fn(name: str, cfg: CNNConfig, params: dict,
            data: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The model's training loss on one batch."""
    logits = getattr(cnn, f"{name}_apply")(cfg, params, data["image"])
    if name == "segnet":
        return segmentation_loss(logits, data["mask"])
    return classification_loss(logits, data["label"])


def train_step(name: str, cfg: CNNConfig, params: dict,
               opt: adamw.AdamWState, data: Dict[str, torch.Tensor],
               opt_cfg: adamw.AdamWConfig
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                          adamw.AdamWState]:
    """One step: the loss, its gradients over `float_leaves(params)`, and
    AdamW applied to those leaves in place (a constant schedule). Returns
    (loss, gradients, the new optimizer state); `opt` is
    `adamw.init(float_leaves(params), opt_cfg)` or a later state."""
    leaves = float_leaves(params)
    loss = loss_fn(name, cfg, params, data)
    grads = torch.autograd.grad(loss, leaves)
    _, opt = adamw.update(list(grads), opt, leaves, opt_cfg)
    return loss.detach(), grads, opt
