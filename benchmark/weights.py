"""Seeded weights for the model, made on the device in one draw.

The benchmark makes the weights; the program and the reference both load
them by state-dict name. One `torch.randn` of every value at once from a
`torch.Generator` on the target device, then a scale per tensor by its kind
(`reference.generation.param_kinds`): kernels and tables N(0, 1/fan_in),
norm scales 1 + 0.1 N, biases and running means 0.1 N, running variances
1 + 0.1 |N|, power-iteration vectors N(0, 1), sigma 1. Non-zero biases and
statistics, so that a path that drops one shows in the outputs.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def make_state(shapes: Dict[str, Tuple[Tuple[int, ...], Tuple[str, float]]],
               seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor on `device`; `shapes` maps each name to (shape,
    (kind, fan_in)) in a fixed order."""
    total = sum(math.prod(s) for s, _ in shapes.values())
    g = torch.Generator(device=device)
    # Any whole number; modulo 2**63 keeps every seed the driver gives
    # distinct.
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=g, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, (kind, fan)) in shapes.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind in ("matrix", "embed"):
            t.mul_(1.0 / math.sqrt(fan))
        elif kind == "scale":
            t.mul_(0.1).add_(1.0)
        elif kind in ("bias", "mean"):
            t.mul_(0.1)
        elif kind == "var":
            t.abs_().mul_(0.1).add_(1.0)
        elif kind == "sigma":
            t.fill_(1.0)
        elif kind != "u":
            raise ValueError(f"unknown kind {kind!r} of {name}")
        out[name] = t
    return out


def spec_of(model: torch.nn.Module, kinds) -> Dict[str, tuple]:
    """(shape, kind) of every state-dict entry of `model`, in its order."""
    return {k: (tuple(v.shape), kinds[k])
            for k, v in model.state_dict().items()}
