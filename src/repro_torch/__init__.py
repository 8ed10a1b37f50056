"""ExSpike in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of `repro` (JAX + Pallas for TPU), with the same module layout:
`configs`, `core`, `data`, `kernels`, `models`, `optim`. Model code
reaches kernels only through the backend registry
(`repro_torch.kernels.dispatch`): on CUDA tensors the hand-written
kernels under `csrc/` run, on CPU tensors the plain PyTorch oracles do.
Every registry op is differentiable (surrogate gradients), so the same
resolution serves inference and training.

Public functions keep the JAX package's layouts: activations NHWC, conv
weights HWIO, matmul weights (d_in, d_out), attention (..., N, d).
Entry points take ``device=`` and default to ``"cuda"``; asking for CUDA
on a machine without it raises instead of running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a `torch.device`, refusing CUDA when no card is present
    (the port never quietly runs a CUDA request on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
