"""Layers of the evaluation networks (InceptionV3, AlexNet, TSM-ResNet50,
ResNeXt3D-101), channels-last as the JAX package's flax modules are.

`Conv` is flax's `nn.Conv` at any spatial rank: weight (O, I/groups,
*kernel) under the weight bridge's names (weights.py), an optional bias,
`feature_group_count` as `groups`, and flax's padding: 'SAME' is XLA's,
which pads (0, 1) for a 3-wide kernel at stride 2 on an even size and (2,
3) for a 7-wide one, where torch's symmetric `padding=` would shift the
grid; 'VALID'; or explicit (low, high) pairs. `max_pool` pads with -inf,
`avg_pool` with zeros counted in the mean (flax's `count_include_pad`).
Padding is applied to the channels-last tensor, so the convs run on a
channels_last view.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ag2video_torch.models.layers import same_padding, trunc_normal_
from ag2video_torch.weights import from_flax, init_params

Padding = Union[str, Sequence[Tuple[int, int]]]


def eval_device(device, who: str) -> torch.device:
    """`device`, or the CUDA card when None, which raises without one."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA card is available; pass "
                           f"device='cpu' to run on the CPU")
    return device


def _tuple(v, n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


def pads(sizes: Sequence[int], window: Sequence[int],
         strides: Sequence[int], padding: Padding) -> Tuple[Tuple[int, int], ...]:
    """(low, high) per spatial axis of flax's 'SAME', 'VALID' or explicit
    padding."""
    if padding == "VALID":
        return tuple((0, 0) for _ in sizes)
    if padding == "SAME":
        return tuple(same_padding(n, k, s)
                     for n, k, s in zip(sizes, window, strides))
    return tuple(tuple(p) for p in padding)


def _pad(x: torch.Tensor, p: Sequence[Tuple[int, int]],
         value: float = 0.0) -> torch.Tensor:
    """F.pad of the spatial axes of (N, *spatial, C)."""
    flat = [0, 0]  # C
    for lo, hi in reversed(p):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _symmetric(p) -> bool:
    return all(lo == hi for lo, hi in p)


class Conv(nn.Module):
    """flax nn.Conv over (N, *spatial, C) (see the module docstring)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int], strides: Union[int, Sequence[int]] = 1,
                 padding: Padding = "SAME", use_bias: bool = True,
                 groups: int = 1):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = _tuple(strides, len(self.kernel))
        self.padding = padding
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_(self, g: torch.Generator) -> None:
        """flax's lecun_normal kernel (fan_in = I/groups * prod(kernel)),
        zero bias."""
        trunc_normal_(self.weight, math.sqrt(1.0 / self.weight[0].numel()), g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = pads(x.shape[1:-1], self.kernel, self.strides, self.padding)
        if _symmetric(p):
            sym = tuple(lo for lo, _ in p)
        else:
            x, sym = _pad(x, p), 0
        conv = F.conv2d if len(self.kernel) == 2 else F.conv3d
        y = conv(x.movedim(-1, 1), self.weight, self.bias, self.strides, sym,
                 1, self.groups)
        return y.movedim(1, -1)


def max_pool(x: torch.Tensor, window: Sequence[int],
             strides: Sequence[int], padding: Padding = "VALID"
             ) -> torch.Tensor:
    """flax nn.max_pool of (N, *spatial, C): padding with -inf."""
    p = pads(x.shape[1:-1], window, strides, padding)
    if any(lo or hi for lo, hi in p):
        x = _pad(x, p, float("-inf"))
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    return pool(x.movedim(-1, 1), tuple(window), tuple(strides)).movedim(1, -1)


def avg_pool(x: torch.Tensor, window: Sequence[int],
             strides: Sequence[int], padding: Padding = "VALID"
             ) -> torch.Tensor:
    """flax nn.avg_pool of (N, H, W, C): the padded zeros count in the
    mean."""
    p = pads(x.shape[1:-1], window, strides, padding)
    if any(lo or hi for lo, hi in p):
        x = _pad(x, p)
    return F.avg_pool2d(x.movedim(-1, 1), tuple(window),
                        tuple(strides)).movedim(1, -1)


def load_variables(model: nn.Module, variables, device: torch.device,
                   seed: int = 0) -> Tuple[nn.Module, bool]:
    """`model` holding `variables` (a flax tree {'params', 'batch_stats'}
    of arrays, loaded strictly) or, when None, seeded weights by flax's
    initialisers (weights.init_params); on `device`, in eval mode, frozen
    -> (model, random_init). Random weights give scores comparable only
    within one configuration, and other scores than the JAX package's
    random init (flax's `init` at PRNGKey(0), which torch cannot
    reproduce)."""
    random_init = variables is None
    if random_init:
        init_params(model, seed)
    else:
        from_flax(variables, model)
    model.requires_grad_(False)
    return model.to(device).eval(), random_init
