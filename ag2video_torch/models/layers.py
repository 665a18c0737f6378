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

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.weight if weight is None else weight
        dt = compute_dtype(x, self.dtype, w, self.bias)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), w.to(dt), b)


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
                dtype: Optional[torch.dtype] = None,
                padding="SAME") -> torch.Tensor:
    """Conv of an (..., H, W, C) tensor with an OIHW weight, computed in
    `dtype` (flax promote_dtype rule); returns (..., Ho, Wo, O). `padding`
    is 'SAME' (flax/XLA's) or explicit ((top, bottom), (left, right))."""
    dt = compute_dtype(x, dtype, weight, bias)
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    k = weight.shape[-1]
    xn = x.to(dt).reshape(-1, H, W, C).permute(0, 3, 1, 2)
    if padding == "SAME":
        ph, pw = same_padding(H, k, stride), same_padding(W, k, stride)
    else:
        ph, pw = (tuple(p) for p in padding)
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
    """flax nn.Conv: weight OIHW, optional bias, padding 'SAME' or explicit
    ((top, bottom), (left, right))."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, padding="SAME"):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.stride = stride
        self.dtype = dtype
        self.padding = padding

    def init_(self, g: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        trunc_normal_(self.weight, math.sqrt(1.0 / (i * kh * kw)), g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.weight if weight is None else weight
        return conv2d_nhwc(x, w, self.bias, self.stride, self.dtype,
                           self.padding)


def transpose_padding(k: int, stride: int) -> Tuple[int, int]:
    """lax.conv_transpose's 'SAME' padding (low, high) of the dilated
    input, for one spatial dim (jax `_conv_transpose_padding`); the output
    is stride * the input size. For k=3, s=2 this is (2, 1)."""
    pad_len = k + stride - 2
    low = k - 1 if stride > k - 1 else -(-pad_len // 2)
    return low, pad_len - low


def conv_transpose2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor], stride: int = 2,
                          dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """flax nn.ConvTranspose (transpose_kernel=False, 'SAME') of an
    (..., H, W, C) tensor -> (..., stride*H, stride*W, O), computed in
    `dtype` (flax promote_dtype rule).

    flax dilates the input by `stride`, pads it (transpose_padding) and
    cross-correlates it with its HWIO kernel as stored: it does not flip the
    kernel. `F.conv_transpose2d` does flip, and takes (I, O, kh, kw): the
    port's `weight` is the flax kernel flipped and in that layout (the
    flip lives in weights.py), so one `F.conv_transpose2d` with no padding
    computes flax's sums, shifted by k-1-low rows and columns and longer at
    the high end; the crop takes flax's stride*H x stride*W window."""
    dt = compute_dtype(x, dtype, weight, bias)
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    k = weight.shape[-1]
    low, high = transpose_padding(k, stride)
    off = k - 1 - low
    if off < 0 or off > k - stride:
        raise ValueError(f"no crop of conv_transpose2d gives lax's 'SAME' "
                         f"window for k={k}, stride={stride}")
    xn = x.to(dt).reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.conv_transpose2d(xn, weight.to(dt),
                           None if bias is None else bias.to(dt),
                           stride=stride)
    y = y[:, :, off:off + stride * H, off:off + stride * W]
    y = y.permute(0, 2, 3, 1)
    return y.reshape(*lead, *y.shape[1:])


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose with 'SAME' padding: weight (in, out, kh, kw),
    the flax HWIO kernel flipped in both spatial axes (see
    conv_transpose2d_nhwc), optional bias. The seeded init is flax's
    lecun-normal, whose fan-in for the kernel (kh, kw, in, out) is
    kh * kw * in."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 2, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(in_features, features, k, k))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.stride = stride
        self.dtype = dtype

    def init_(self, g: torch.Generator) -> None:
        i, o, kh, kw = self.weight.shape
        trunc_normal_(self.weight, math.sqrt(1.0 / (i * kh * kw)), g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        w = self.weight if weight is None else weight
        return conv_transpose2d_nhwc(x, w, self.bias, self.stride, self.dtype)


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
    """Nearest-neighbour x`factor` upsample of (..., H, W, C), contiguous:
    the reshape copies but for a 1x1 map, where it is a stride-0 view."""
    *B, H, W, C = x.shape
    x = x.reshape(*B, H, 1, W, 1, C).expand(*B, H, factor, W, factor, C)
    return x.reshape(*B, H * factor, W * factor, C).contiguous()


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


def avg_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    """F.avg_pool2d(k=3, s=2, p=1, count_include_pad=False) of (..., H, W,
    C): the multiscale discriminator's downsample.

    The pool runs on a contiguous NCHW copy: on CUDA (PyTorch 2.11),
    avg_pool2d's backward at this window on a channels_last input returns
    a wrong input gradient (rel-L2 ~1 against the CPU; the forward is
    right), and this gradient reaches the generator through the
    discriminator's second scale."""
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    xn = x.reshape(-1, H, W, C).permute(0, 3, 1, 2).contiguous()
    y = F.avg_pool2d(xn, 3, 2, 1, count_include_pad=False).permute(0, 2, 3, 1)
    return y.reshape(*lead, *y.shape[1:])


def get_activation(name: Optional[str]):
    """Activation by name, 'leakyrelu-<slope>' included (reference
    layers.py:115)."""
    if name is None:
        return lambda x: x
    low = name.lower()
    if low.startswith("leakyrelu"):
        slope = float(low.split("-")[1]) if "-" in low else 0.01
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    table = {"relu": torch.relu, "sigmoid": torch.sigmoid,
             "tanh": torch.tanh, "none": lambda x: x}
    if low not in table:
        raise ValueError(f"Invalid activation {name!r}")
    return table[low]


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., C) (reference layers.py:184-187)."""
    return x.mean(dim=(-3, -2))


def _norm2d(kind: str, features: int) -> Optional[nn.Module]:
    """SpecCNN's norm: None, flax's BatchNorm (momentum 0.99, eps 1e-5) or
    the instance norm (flax GroupNorm with a group per channel, no scale or
    bias, eps 1e-6)."""
    from ag2video_torch.models.normalization import BatchNorm, GroupNorm

    if kind == "none":
        return None
    if kind == "batch":
        return BatchNorm(features)
    if kind == "instance":
        return GroupNorm(None, eps=1e-6)
    raise ValueError(f"Unrecognized normalization {kind!r}")


class SpecCNN(nn.Module):
    """String-spec CNN (reference models/layers.py:28-112), channels-last.

    The grammar of the crop discriminators ('C4-64-2,C4-128-2,C4-256-2'):
    `IX` (X input channels, first only; 3 without it), `CK-X[-S]` (a KxK
    conv to X channels at stride S; every conv but the first is preceded by
    the norm and the activation), `R` (a residual block of two 3x3 convs,
    each after norm and activation; no norm when it comes first), `UX`
    (nearest upsample by X), `PX` (an X-by-X pool, stride X, 'VALID'), and
    `FC-Din-Dout` (flatten in NHWC order, Dense, then the activation unless
    it is the last layer). Submodules carry flax's names: `conv_{i}`,
    `norm_{i}`, `res_{i}_{c0,c1,n0,n1}`, `fc_{i}` for the i-th spec.
    """

    def __init__(self, arch: str, normalization: str = "batch",
                 activation: str = "relu", padding: str = "same",
                 pooling: str = "max", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.specs, cur_c = self.parse(arch)
        self.act = get_activation(activation)
        if pooling not in ("max", "avg"):
            raise ValueError(f"Unrecognized pooling {pooling!r}")
        self.pooling = pooling
        pad = "SAME" if padding == "same" else ((0, 0), (0, 0))
        first_conv = True
        for i, s in enumerate(self.specs):
            if s[0] == "C":
                vals = [int(v) for v in s[1:].split("-")]
                K, next_c = vals[0], vals[1]
                stride = vals[2] if len(vals) == 3 else 1
                if not first_conv:
                    self._add(f"norm_{i}", _norm2d(normalization, cur_c))
                first_conv = False
                setattr(self, f"conv_{i}", Conv(cur_c, next_c, K, stride,
                                                dtype=dtype, padding=pad))
                cur_c = next_c
            elif s[0] == "R":
                norm = "none" if first_conv else normalization
                first_conv = False
                for j in range(2):
                    self._add(f"res_{i}_n{j}", _norm2d(norm, cur_c))
                    setattr(self, f"res_{i}_c{j}",
                            Conv(cur_c, cur_c, 3, dtype=dtype))
            elif s.startswith("FC"):
                _, din, dout = s.split("-")
                setattr(self, f"fc_{i}", Dense(int(din), int(dout),
                                               dtype=dtype))
                cur_c = int(dout)
            elif s[0] not in "UP":
                raise ValueError(f"Invalid layer spec {s!r}")

    def _add(self, name: str, module: Optional[nn.Module]) -> None:
        if module is not None:
            setattr(self, name, module)

    @staticmethod
    def parse(arch):
        specs = arch.split(",") if isinstance(arch, str) else list(arch)
        cur_c = 3
        if specs and specs[0][0] == "I":
            cur_c = int(specs[0][1:])
            specs = specs[1:]
        return specs, cur_c

    @classmethod
    def out_channels(cls, arch) -> int:
        specs, cur_c = cls.parse(arch)
        for s in specs:
            if s[0] == "C":
                cur_c = int(s[1:].split("-")[1])
            elif s.startswith("FC"):
                cur_c = int(s.split("-")[2])
        return cur_c

    def _norm(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        norm = getattr(self, name, None)
        return x if norm is None else norm(x, train)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        first_conv = True
        for i, s in enumerate(self.specs):
            if s[0] == "C":
                if not first_conv:
                    x = self.act(self._norm(f"norm_{i}", x, train))
                first_conv = False
                x = getattr(self, f"conv_{i}")(x)
            elif s[0] == "R":
                first_conv = False
                y = x
                for j in range(2):
                    y = self.act(self._norm(f"res_{i}_n{j}", y, train))
                    y = getattr(self, f"res_{i}_c{j}")(y)
                x = x + y
            elif s[0] == "U":
                x = upsample_nearest(x, int(s[1:]))
            elif s[0] == "P":
                f = int(s[1:])
                lead = x.shape[:-3]
                xn = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)
                pool = F.max_pool2d if self.pooling == "max" else F.avg_pool2d
                xn = pool(xn, f, f)
                x = xn.permute(0, 2, 3, 1).reshape(*lead, *xn.shape[2:],
                                                   xn.shape[1])
            else:  # FC
                x = getattr(self, f"fc_{i}")(x.reshape(x.shape[0], -1))
                if i + 1 < len(self.specs):
                    x = self.act(x)
        return x
