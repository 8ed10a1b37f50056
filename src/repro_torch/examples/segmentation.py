"""Spiking SegNet (the paper's segmentation workload) trained end-to-end
on the synthetic lane dataset — exercising direct coding (OPT1), EConv
(OPT2) economics, and per-pixel spike decoding. Each step is
`launch.cnn_train.train_step`: autograd through the registry's kernels
and AdamW.

Run: PYTHONPATH=src python -m repro_torch.examples.segmentation
     [--steps 60] [--batch 8] [--img 32] [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import CNNConfig
from repro_torch.launch import cnn_train
from repro_torch.models import cnn
from repro_torch.optim import adamw


def iou(cfg, params, imgs, masks) -> float:
    """Lane IoU of the argmax prediction."""
    with torch.no_grad():
        pred = cnn.segnet_apply(cfg, params, imgs).argmax(dim=-1)
    inter = ((pred == 1) & (masks == 1)).sum().item()
    union = ((pred == 1) | (masks == 1)).sum().item()
    return inter / max(union, 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = CNNConfig(name="segnet", layers=cnn.SEGNET_LAYERS, img=args.img,
                    n_classes=2)
    params = cnn_train.init_params("segnet", cfg, seed=0, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=2e-3, weight_decay=0.01)
    opt = adamw.init(cnn_train.float_leaves(params), opt_cfg)

    val = cnn_train.batch("segnet", cfg, 99, 0, 16, device=dev)
    vi, vm = val["image"], val["mask"]
    first = iou(cfg, params, vi, vm)
    print(f"initial lane IoU: {first:.3f}")
    losses = []
    for s in range(args.steps):
        b = cnn_train.batch("segnet", cfg, 0, s, args.batch, device=dev)
        loss, _, opt = cnn_train.train_step("segnet", cfg, params, opt, b,
                                            opt_cfg)
        losses.append(float(loss))
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:3d} loss {losses[-1]:.4f}")
    final = iou(cfg, params, vi, vm)
    print(f"final lane IoU: {final:.3f}")

    # Event economics on the trained model (Fig. 2 style)
    with torch.no_grad():
        _, stats = cnn.segnet_apply(cfg, params, vi, collect_stats=True)
    rates = [float(s.float().mean()) for s in stats]
    for i, r in enumerate(rates):
        print(f"  layer {i}: sparsity {1 - r:.2%} "
              f"-> econv does {r:.2%} of tconv work")
    return dict(initial_iou=first, final_iou=final, losses=losses,
                rates=rates)


if __name__ == "__main__":
    main()
