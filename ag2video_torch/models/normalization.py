"""Normalization layers (port of ag2video_tpu/models/normalization.py):
BatchNorm, GroupNorm (the 'instance' and 'group' norms), the param-free
norm, SPADE, spectral-norm convs and the spectral-norm Dense.

Train mode is an explicit argument, `train`, threaded through every
forward as the JAX package threads it; `module.training` is not read. With
`train=True` a BatchNorm normalises by the batch statistics and updates its
running averages, and a spectral norm writes its power-iteration state;
with `train=False` both read their stored state and write nothing. (The
training step runs the discriminator with `train=False` in the generator
step and with `train=True` in its own step, as the JAX trainer does.)

Statistics follow flax (0.12): taken in fp32 over every axis but the last
(BatchNorm) or over the spatial axes and the channels of a group
(GroupNorm), with the "fast" variance max(0, E[x^2] - E[x]^2), which is the
biased variance; the running averages move as flax's do,
`ra = m * ra + (1 - m) * stat` (m = 0.99 by default, 0.9 in the param-free
norm). `F.batch_norm` would store the unbiased variance, and its momentum
is the complement.

Spectral norm follows flax `SpectralNorm`, not
`torch.nn.utils.spectral_norm`: the HWIO kernel is viewed as (-1, out), one
power iteration runs from the stored `u` (l2-normalised with eps 1e-12), and
the kernel is divided by sigma = v K u^T when sigma != 0; `u` and `v` carry
no gradient, sigma carries the kernel's; the bias is left alone. flax runs
that iteration on every call, update_stats=False included. Without an update
and without a gradient to take, the port computes the normalised kernel once
and caches it until the kernel or `u` changes (`SpectralWeight`): exact, and
free per frame.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch
from torch import nn

from ag2video_torch.models.layers import (Conv, ConvTranspose, Dense,
                                          conv2d_nhwc, leaky_relu_02,
                                          resize_nearest)
from ag2video_torch.ops import denorm as denorm_ops
from ag2video_torch.parallel.mesh import AllReduceSum, current_data_group


def parse_spade_norm(config_text: str):
    """'spade(norm)(k)x(k)' -> (param_free_norm_type, kernel_size)."""
    m = re.search(r"spade(\D+)(\d)x\d", config_text)
    if not m:
        raise ValueError(f"Bad SPADE config {config_text!r}")
    return m.group(1), int(m.group(2))


def split_norm(norm: str):
    """'spectralinstance' -> (spectral, subnorm, has_subnorm)."""
    spectral = norm.startswith("spectral")
    subnorm = norm[len("spectral"):] if spectral else norm
    return spectral, subnorm, subnorm not in ("", "none")


BATCH_KINDS = ("batch", "sync_batch", "syncbatch")


def fp32_stats(x: torch.Tensor, dims: Sequence[int]):
    """flax `_compute_stats`: fp32 mean and max(0, E[x^2] - E[x]^2)."""
    xf = x.float()
    mean = xf.mean(dims)
    var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    return mean, var


def global_stats(x: torch.Tensor, dims: Sequence[int], group):
    """`fp32_stats` over the global batch of a data axis (parallel/mesh.py):
    fp32 sum(x), sum(x^2) and the element count of each rank, summed over
    `group` by one differentiable all-reduce, then the mean and flax's fast
    variance max(0, E[x^2] - E[x]^2)."""
    xf = x.float()
    s1 = xf.sum(dims)
    n = torch.full_like(s1, xf.numel() // s1.numel())
    s1, s2, n = AllReduceSum.apply(
        torch.stack([s1, (xf * xf).sum(dims), n]), group).unbind()
    mean = s1 / n
    return mean, torch.clamp(s2 / n - mean * mean, min=0.0)


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              eps: float, weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor],
              dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax `_normalize`: (x - mean) * (rsqrt(var + eps) * scale) + bias in
    fp32, returned in `dtype` (or the promoted type of x and the params)."""
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x.float() - mean) * mul
    if bias is not None:
        y = y + bias
    out = dtype
    if out is None:
        out = x.dtype
        for p in (weight, bias):
            if p is not None:
                out = torch.promote_types(out, p.dtype)
    return y.to(out)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the last axis: batch statistics over every
    other axis and a running-average update when `train`, the running
    statistics otherwise. Inside a `parallel.data_scope` of more than one
    rank, the batch statistics are the global batch's (`global_stats`),
    as under the JAX package's data axis, so every rank moves its running
    averages alike."""

    def __init__(self, features: int, use_scale: bool = True,
                 use_bias: bool = True, eps: float = 1e-5,
                 momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self._affine = None

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def eval_affine(self):
        """(mean, mul, shift): the fp32 running mean, rsqrt(running_var +
        eps) * scale and the bias (None without one) that `normalize`
        applies with `train=False`, computed as it computes them; cached
        until a buffer or parameter is replaced or written."""
        parts = (self.running_mean, self.running_var, self.weight, self.bias)
        key = tuple((id(t), t._version) if t is not None else None
                    for t in parts)
        c = self._affine
        if c is not None and c[0] == key:
            return c[1]
        # Normal tensors even under inference_mode, as SpectralWeight's.
        with torch.inference_mode(False), torch.no_grad():
            mul = torch.rsqrt(self.running_var + self.eps)
            if self.weight is not None:
                mul = mul * self.weight
            affine = (self.running_mean.float().contiguous(),
                      mul.float().contiguous(),
                      None if self.bias is None
                      else self.bias.float().contiguous())
        self._affine = (key, affine, parts)
        return affine

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return normalize(x, self.running_mean, self.running_var,
                             self.eps, self.weight, self.bias, self.dtype)
        dims = tuple(range(x.dim() - 1))
        group = current_data_group()
        if group is None:
            mean, var = fp32_stats(x, dims)
        else:
            mean, var = global_stats(x, dims, group)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1 - m) * var.detach())
        return normalize(x, mean, var, self.eps, self.weight, self.bias,
                         self.dtype)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm without scale or bias (no state): per sample,
    statistics over the spatial axes and the channels of each of
    `num_groups` groups (None: one group per channel, the 'instance'
    norm)."""

    def __init__(self, num_groups: Optional[int] = None, eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        C = x.shape[-1]
        G = self.num_groups or C
        xg = x.reshape(*x.shape[:-1], G, C // G)
        dims = tuple(range(1, x.dim() - 1)) + (x.dim(),)
        mean, var = fp32_stats(xg, dims)  # (N, G)
        per_channel = (x.shape[0],) + (1,) * (x.dim() - 2) + (C,)
        if G != C:
            mean = mean.repeat_interleave(C // G, -1)
            var = var.repeat_interleave(C // G, -1)
        return normalize(x, mean.reshape(per_channel),
                         var.reshape(per_channel), self.eps, None, None,
                         self.dtype)


def subnorm_layer(subnorm: str, features: int,
                  dtype: Optional[torch.dtype]) -> nn.Module:
    """NormConv / FlowResBlock / FactorizedNormConv subnorm: BatchNorm with
    flax's defaults (momentum 0.99, eps 1e-5) or the instance norm (eps
    1e-6), in the layer's dtype."""
    if subnorm in BATCH_KINDS:
        return BatchNorm(features, dtype=dtype)
    if subnorm == "instance":
        return GroupNorm(None, dtype=dtype)
    raise ValueError(f"normalization layer {subnorm!r} is not recognized")


class ParamFreeNorm(nn.Module):
    """Affine-free norm: 'batch'/'syncbatch' (momentum 0.9, eps 1e-5),
    'instance' (eps 1e-5) or 'group' (min(32, C) groups, eps 1e-6)."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        # One attribute name for every kind: only BatchNorm has state, and
        # flax names it `bn`.
        if kind in BATCH_KINDS:
            self.bn = BatchNorm(features, use_scale=False, use_bias=False,
                                momentum=0.9)
        elif kind == "instance":
            self.bn = GroupNorm(None, eps=1e-5)
        elif kind == "group":
            self.bn = GroupNorm(min(32, features))
        else:
            raise ValueError(f"Unrecognized param-free norm {kind!r}")

    @property
    def running(self) -> bool:
        """Whether eval mode normalises by running statistics (the batch
        kinds), not by each sample's own."""
        return isinstance(self.bn, BatchNorm)

    def running_stats(self):
        """(mean, mul): the fp32 running mean and rsqrt(running_var + eps)
        that `normalize` applies with `train=False` (`BatchNorm.eval_affine`,
        cached there)."""
        return self.bn.eval_affine()[:2]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(x, train)


class SpectralWeight(nn.Module):
    """flax SpectralNorm state for one OIHW kernel (or, `transposed`, one
    ConvTranspose kernel: (in, out, kh, kw), flipped): buffers `u` (1, out)
    and `sigma` (), and the normalised kernel (see the module docstring)."""

    def __init__(self, features: int, eps: float = 1e-12,
                 transposed: bool = False):
        super().__init__()
        self.register_buffer("u", torch.zeros(1, features))
        self.register_buffer("sigma", torch.ones(()))
        self.eps = eps
        self.transposed = transposed
        self._cache = None

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.u.copy_(torch.randn(self.u.shape, generator=g))
            self.sigma.fill_(1.0)
        self._cache = None

    def _l2n(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).sum() + self.eps)

    def matrix(self, weight: torch.Tensor) -> torch.Tensor:
        """The fp32 (-1, out) matrix flax's SpectralNorm normalises: the
        flax kernel (a Dense kernel (in, out), a conv kernel HWIO, a
        ConvTranspose kernel (kh, kw, in, out)) reshaped to (-1, out)."""
        if weight.dim() == 2:  # a Dense kernel: (out, in) -> flax's (in, out)
            value = weight.float().t()
        elif self.transposed:  # back to the flax kernel (kh, kw, in, out)
            value = weight.float().flip(2, 3).permute(2, 3, 0, 1)
        else:
            value = weight.float().permute(2, 3, 1, 0)
        return value.reshape(-1, value.shape[-1])

    def _normalize(self, weight: torch.Tensor, update_stats: bool):
        value = self.matrix(weight)
        with torch.no_grad():
            vd = value.detach()
            v = self._l2n(self.u.float() @ vd.t())
            u = self._l2n(v @ vd)
        sigma = ((v @ value) @ u.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma.detach())
        # In the promoted type of the kernel and sigma (fp32 for bf16
        # params), as flax returns it.
        return weight.to(sigma.dtype) / torch.where(sigma != 0, sigma,
                                                    torch.ones_like(sigma))

    def normalize(self, weight: torch.Tensor,
                  update_stats: bool = False) -> torch.Tensor:
        """(out, in, kh, kw) kernel -> kernel / sigma, sigma from one power
        iteration from `u` on the kernel viewed as (kh*kw*in, out) (a
        transposed kernel is viewed through its flax layout, a Dense kernel
        (out, in) as (in, out)); with `update_stats`, the new `u` and sigma
        are stored."""
        if update_stats or (torch.is_grad_enabled() and weight.requires_grad):
            return self._normalize(weight, update_stats)
        key = (weight.data_ptr(), weight._version, weight.dtype,
               self.u.data_ptr(), self.u._version)
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        # A normal tensor even under inference_mode, so that a later call
        # with autograd on can use the cache.
        with torch.inference_mode(False), torch.no_grad():
            w = self._normalize(weight.detach(), False)
        self._cache = (key, w)
        return w


class SNConv(nn.Module):
    """Conv with optional spectral norm (flax SNConv: submodule `conv`)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, use_bias: bool = True, spectral: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(in_features, features, kernel_size, stride, use_bias,
                         dtype)
        self.spectral = SpectralWeight(features) if spectral else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.spectral is None:
            return self.conv(x)
        return self.conv(x, self.spectral.normalize(self.conv.weight, train))


class SNDense(nn.Module):
    """Dense with optional spectral norm (flax SNDense: submodule `dense`;
    one power iteration per call, the state written when `train`)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 spectral: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = Dense(in_features, features, use_bias, dtype)
        self.spectral = SpectralWeight(features) if spectral else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.spectral is None:
            return self.dense(x)
        return self.dense(x, self.spectral.normalize(self.dense.weight, train))


class NormConv(nn.Module):
    """get_nonspade_norm_layer: (spectral) conv, then an optional subnorm
    (BatchNorm or the instance norm, submodule `norm`). The conv has no bias
    when a subnorm follows. `padding` is 'SAME' or ((top, bottom), (left,
    right)), as flax takes it. `transpose`: the conv is flax's
    ConvTranspose ('SAME' only; layers.ConvTranspose), the flow net's
    `flow_deconv` decoder."""

    def __init__(self, in_features: int, features: int, norm: str,
                 kernel_size: int = 3, stride: int = 1, padding="SAME",
                 dtype: Optional[torch.dtype] = None,
                 transpose: bool = False):
        super().__init__()
        spectral, subnorm, has_subnorm = split_norm(norm)
        if transpose:
            if padding != "SAME":
                raise ValueError("a transposed NormConv pads 'SAME' only")
            self.conv = ConvTranspose(in_features, features, kernel_size,
                                      stride, use_bias=not has_subnorm,
                                      dtype=dtype)
        else:
            self.conv = Conv(in_features, features, kernel_size, stride,
                             use_bias=not has_subnorm, dtype=dtype,
                             padding=padding)
        self.spectral = SpectralWeight(features, transposed=transpose) \
            if spectral else None
        self.norm = subnorm_layer(subnorm, features, dtype) \
            if has_subnorm else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.spectral is None:
            x = self.conv(x)
        else:
            x = self.conv(x, self.spectral.normalize(self.conv.weight, train))
        return x if self.norm is None else self.norm(x, train)


class SPADE(nn.Module):
    """Spatially-adaptive denormalization (reference normalization.py:66-110):
    out = param_free_norm(x) * (1 + gamma) + beta, with gamma/beta convs over
    relu(shared conv(segmap resized to x)). nhidden = 128.

    The three convs are separate parameters (`mlp_shared`, `mlp_gamma`,
    `mlp_beta`); SPADEResnetBlock fuses the convs of its norms at run time.
    """

    def __init__(self, config_text: str, norm_nc: int, label_nc: int,
                 dtype: Optional[torch.dtype] = None, nhidden: int = 128):
        super().__init__()
        norm_type, ks = parse_spade_norm(config_text)
        self.param_free_norm = ParamFreeNorm(norm_type, norm_nc)
        self.mlp_shared = Conv(label_nc, nhidden, ks, dtype=dtype)
        self.mlp_gamma = Conv(nhidden, norm_nc, ks, dtype=dtype)
        self.mlp_beta = Conv(nhidden, norm_nc, ks, dtype=dtype)
        self.nhidden = nhidden
        self.dtype = dtype

    def gamma_beta_kernels(self):
        """(weight, bias) of the nhidden -> 2*nc merged gamma|beta conv."""
        return (torch.cat([self.mlp_gamma.weight, self.mlp_beta.weight], 0),
                torch.cat([self.mlp_gamma.bias, self.mlp_beta.bias], 0))

    def normalize_affine(self, x, gamma, beta, train: bool = False):
        return self.param_free_norm(x, train) * (1 + gamma) + beta

    def denorm(self, x: torch.Tensor, gb: torch.Tensor, train: bool = False,
               act: bool = False) -> torch.Tensor:
        """`normalize_affine` with gamma | beta the two halves of gb (...,
        2C), then the stack's leaky ReLU if `act`. Where `denorm_ops.route`
        says so (CUDA tensors outside `ops.plain()`, eval mode, running
        statistics, no gradient to take) one launch of csrc/denorm.cu
        computes it, bit-equal to the eager ops; otherwise the eager ops."""
        needs_grad = torch.is_grad_enabled() and (x.requires_grad
                                                  or gb.requires_grad)
        pfn = self.param_free_norm
        if denorm_ops.route(x.device.type, train, pfn.running,
                            needs_grad) == "kernel":
            return denorm_ops.denorm_fused(x, gb, *pfn.running_stats(), act)
        nc = x.shape[-1]
        y = self.normalize_affine(x, gb[..., :nc], gb[..., nc:], train)
        return leaky_relu_02(y) if act else y

    def forward(self, x: torch.Tensor, segmap: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        seg = resize_nearest(segmap, tuple(x.shape[-3:-1]))
        actv = torch.relu(self.mlp_shared(seg))
        gb = conv2d_nhwc(actv, *self.gamma_beta_kernels(), dtype=self.dtype)
        return self.denorm(x, gb, train)
