"""LR schedules (pure functions of the step), the port of
`repro.optim.schedule`. Each returns a float32 scalar tensor multiplier
on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int = 100, total_steps: int = 10_000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) /
                       max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, value: float = 1.0) -> torch.Tensor:
    device = step.device if isinstance(step, torch.Tensor) else None
    return torch.tensor(value, dtype=torch.float32, device=device)
