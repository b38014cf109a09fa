"""Learning-rate schedules (reference: ``repro/optim/schedules.py``):
step -> lr functions on a step tensor, computed in float32 with the
reference's expression order (a Python scalar meets a float32 tensor as
a float32 value, as a weak-typed scalar does in JAX)."""
from __future__ import annotations

import math

import torch


def make_schedule(kind: str = "cosine", peak: float = 3e-4,
                  warmup_steps: int = 100, total_steps: int = 10_000,
                  floor: float = 0.0):
    """``kind``: cosine, linear or constant; each warms up linearly from 0
    to ``peak`` over ``warmup_steps`` (at least 1). Returns a function of
    an integer step tensor that gives a float32 scalar tensor."""
    warmup_steps = max(warmup_steps, 1)
    span = max(total_steps - warmup_steps, 1)

    def cosine(step):
        s = step.to(torch.float32)
        warm = peak * s / warmup_steps
        frac = torch.clamp((s - warmup_steps) / span, 0.0, 1.0)
        decay = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, decay)

    def linear(step):
        s = step.to(torch.float32)
        warm = peak * s / warmup_steps
        frac = torch.clamp((s - warmup_steps) / span, 0.0, 1.0)
        return torch.where(s < warmup_steps, warm,
                           peak * (1 - frac) + floor * frac)

    def constant(step):
        s = step.to(torch.float32)
        return torch.where(s < warmup_steps, peak * s / warmup_steps,
                           torch.full_like(s, peak))

    return {"cosine": cosine, "linear": linear, "constant": constant}[kind]
