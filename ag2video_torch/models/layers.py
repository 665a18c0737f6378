"""Generic building blocks (port of ag2video_tpu/models/layers.py).

`Dense`, `Conv` and `Embed` are the flax layers' counterparts: the same
parameter names (by the weight bridge's mapping, weights.py), the same
dtype rule (`dtype` set: inputs and parameters are cast to it; unset: the
promoted type), and flax's initialisers by name (`init_` methods, used by
weights.init_params). Tensors are channels-last as in the JAX package; a
conv runs on a permuted view, which PyTorch treats as channels_last NCHW.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(x: torch.Tensor, dtype: Optional[torch.dtype],
                  *params: Optional[torch.Tensor]) -> torch.dtype:
    """flax promote_dtype: `dtype` when set, else the promoted input type."""
    if dtype is not None:
        return dtype
    out = x.dtype
    for p in params:
        if p is not None:
            out = torch.promote_types(out, p.dtype)
    return out


def trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """jax variance_scaling 'truncated_normal': N(0, 1) cut at +-2, rescaled
    so the cut distribution has standard deviation `std`."""
    with torch.no_grad():
        cpu = torch.empty(t.shape, dtype=torch.float32)
        nn.init.trunc_normal_(cpu, 0.0, 1.0, -2.0, 2.0, generator=g)
        t.copy_(cpu * (std / 0.87962566103423978))


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=g) * std)


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    """The SPADE stack's activation (reference architecture.py:67-68)."""
    return F.leaky_relu(x, negative_slope=0.2)


class Dense(nn.Module):
    """flax nn.Dense: y = x @ W^T + b, weight stored (out, in)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, init_scale: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype
        self.init_scale = init_scale  # 1: lecun_normal; 2: kaiming_normal

    def init_(self, g: torch.Generator) -> None:
        fan_in = self.weight.shape[1]
        trunc_normal_(self.weight, math.sqrt(self.init_scale / fan_in), g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(x, self.dtype, self.weight, self.bias)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Embed(nn.Module):
    """flax nn.Embed: table (num, features), default init N(0, 1/features)."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))
        self.dtype = dtype

    def init_(self, g: torch.Generator) -> None:
        normal_(self.weight, 1.0 / math.sqrt(self.weight.shape[1]), g)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        w = self.weight if self.dtype is None else self.weight.to(self.dtype)
        return F.embedding(idx.long(), w)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA 'SAME' padding (low, high) for one spatial dim. For k=3,
    s=2 on an even size this is (0, 1), not torch's symmetric (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor], stride: int = 1,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """SAME conv of an (..., H, W, C) tensor with an OIHW weight, computed
    in `dtype` (flax promote_dtype rule); returns (..., Ho, Wo, O)."""
    dt = compute_dtype(x, dtype, weight, bias)
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    k = weight.shape[-1]
    xn = x.to(dt).reshape(-1, H, W, C).permute(0, 3, 1, 2)
    ph, pw = same_padding(H, k, stride), same_padding(W, k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        padding = (ph[0], pw[0])
    else:
        xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
        padding = (0, 0)
    y = F.conv2d(xn, weight.to(dt), None if bias is None else bias.to(dt),
                 stride=stride, padding=padding)
    y = y.permute(0, 2, 3, 1)
    return y.reshape(*lead, *y.shape[1:])


class Conv(nn.Module):
    """flax nn.Conv with SAME padding: weight OIHW, optional bias."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.stride = stride
        self.dtype = dtype

    def init_(self, g: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        trunc_normal_(self.weight, math.sqrt(1.0 / (i * kh * kw)), g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.weight if weight is None else weight
        return conv2d_nhwc(x, w, self.bias, self.stride, self.dtype)


class MLP(nn.Module):
    """build_mlp (reference models/layers.py:6-25): relu between layers,
    and a final relu unless `final_relu` is False (box_net)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 final_relu: bool = True, init_scale: float = 1.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n = len(features)
        dims = [in_features, *features]
        for i in range(self.n):
            setattr(self, f"dense_{i}", Dense(dims[i], dims[i + 1],
                                              dtype=dtype,
                                              init_scale=init_scale))
        self.final_relu = final_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1 or self.final_relu:
                x = F.relu(x)
        return x


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour x`factor` upsample of (..., H, W, C)."""
    *B, H, W, C = x.shape
    x = x.reshape(*B, H, 1, W, 1, C).expand(*B, H, factor, W, factor, C)
    return x.reshape(*B, H * factor, W * factor, C)


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """F.interpolate(mode='nearest') parity: src = floor(dst * in / out),
    (..., H, W, C). At identity size the input is returned unchanged."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = size
    if (H, W) == (Ho, Wo):
        return x
    dev = x.device
    iy = torch.floor(torch.arange(Ho, dtype=torch.float32, device=dev)
                     * (H / Ho)).long()
    ix = torch.floor(torch.arange(Wo, dtype=torch.float32, device=dev)
                     * (W / Wo)).long()
    return x.index_select(-3, iy).index_select(-2, ix)
