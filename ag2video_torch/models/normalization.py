"""Normalization layers (port of ag2video_tpu/models/normalization.py):
eval-mode BatchNorm, the param-free norm, SPADE, spectral-norm convs.

Only inference ('syncbatch' norms read their running statistics) is ported;
a layer put in training mode raises, because batch statistics and the
spectral power-iteration update belong to the training slice.

Spectral norm follows flax `SpectralNorm` (flax 0.12.3), not
`torch.nn.utils.spectral_norm`: the HWIO kernel is viewed as (-1, out), one
power iteration runs from the stored `u` (l2-normalised with eps 1e-12), and
the kernel is divided by sigma when sigma != 0; the bias is left alone. flax
runs that iteration on every call, update_stats=False included. Eval never
updates `u`, so the port computes the normalised kernel once and caches it
until the kernel or `u` changes (`SpectralWeight`): exact, and free per frame.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from ag2video_torch.models.layers import Conv, conv2d_nhwc, resize_nearest


def parse_spade_norm(config_text: str):
    """'spade(norm)(k)x(k)' -> (param_free_norm_type, kernel_size)."""
    m = re.search(r"spade(\D+)(\d)x\d", config_text)
    if not m:
        raise ValueError(f"Bad SPADE config {config_text!r}")
    return m.group(1), int(m.group(2))


def _eval_only(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__} is ported for inference only; "
            "training-mode norms come with the training slice (ROADMAP)")


class BatchNorm(nn.Module):
    """flax nn.BatchNorm with use_running_average=True over the last axis:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias in fp32, returned in
    `dtype` (or x's dtype when unset, as flax canonicalises it)."""

    def __init__(self, features: int, use_scale: bool = True,
                 use_bias: bool = True, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        self.dtype = dtype

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _eval_only(self)
        mul = torch.rsqrt(self.running_var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x.float() - self.running_mean) * mul
        if self.bias is not None:
            y = y + self.bias
        out = self.dtype
        if out is None:
            out = x.dtype
            for p in (self.weight, self.bias):
                if p is not None:
                    out = torch.promote_types(out, p.dtype)
        return y.to(out)


class ParamFreeNorm(nn.Module):
    """Affine-free 'batch'/'syncbatch' norm (eval: running statistics)."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        if kind not in ("batch", "syncbatch", "sync_batch"):
            raise NotImplementedError(
                f"param-free norm {kind!r} is not ported yet (ROADMAP)")
        self.bn = BatchNorm(features, use_scale=False, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class SpectralWeight(nn.Module):
    """flax SpectralNorm state for one OIHW kernel: buffers `u` (1, out) and
    `sigma` (), and the normalised kernel (see the module docstring)."""

    def __init__(self, features: int, eps: float = 1e-12):
        super().__init__()
        self.register_buffer("u", torch.zeros(1, features))
        self.register_buffer("sigma", torch.ones(()))
        self.eps = eps
        self._cache = None

    def init_(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.u.copy_(torch.randn(self.u.shape, generator=g))
            self.sigma.fill_(1.0)
        self._cache = None

    def _l2n(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).sum() + self.eps)

    def normalize(self, weight: torch.Tensor) -> torch.Tensor:
        """(out, in, kh, kw) kernel -> kernel / sigma, sigma from one power
        iteration from `u` on the kernel viewed as (kh*kw*in, out)."""
        _eval_only(self)
        key = (weight.data_ptr(), weight._version, weight.dtype,
               self.u.data_ptr(), self.u._version)
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        # A normal tensor even under inference_mode, so that a later call
        # with autograd on can use the cache.
        with torch.inference_mode(False), torch.no_grad():
            value = weight.detach().float().permute(2, 3, 1, 0)
            value = value.reshape(-1, value.shape[-1])  # HWIO -> (-1, out)
            v = self._l2n(self.u.float() @ value.t())
            u = self._l2n(v @ value)
            sigma = ((v @ value) @ u.t())[0, 0]
            w = weight.detach() / torch.where(sigma != 0, sigma,
                                              torch.ones_like(sigma))
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spectral is None:
            return self.conv(x)
        return self.conv(x, self.spectral.normalize(self.conv.weight))


class NormConv(nn.Module):
    """get_nonspade_norm_layer: (spectral) conv, then an optional subnorm.
    The conv has no bias when a subnorm follows."""

    def __init__(self, in_features: int, features: int, norm: str,
                 kernel_size: int = 3, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        spectral = norm.startswith("spectral")
        subnorm = norm[len("spectral"):] if spectral else norm
        has_subnorm = subnorm not in ("", "none")
        if has_subnorm and subnorm not in ("batch", "sync_batch", "syncbatch"):
            raise NotImplementedError(
                f"NormConv subnorm {subnorm!r} is not ported yet (ROADMAP)")
        self.conv = Conv(in_features, features, kernel_size, stride,
                         use_bias=not has_subnorm, dtype=dtype)
        self.spectral = SpectralWeight(features) if spectral else None
        self.norm = BatchNorm(features, dtype=dtype) if has_subnorm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spectral is None:
            x = self.conv(x)
        else:
            x = self.conv(x, self.spectral.normalize(self.conv.weight))
        return x if self.norm is None else self.norm(x)


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

    def normalize_affine(self, x, gamma, beta):
        return self.param_free_norm(x) * (1 + gamma) + beta

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        nc = x.shape[-1]
        seg = resize_nearest(segmap, tuple(x.shape[-3:-1]))
        actv = torch.relu(self.mlp_shared(seg))
        gb = conv2d_nhwc(actv, *self.gamma_beta_kernels(), dtype=self.dtype)
        return self.normalize_affine(x, gb[..., :nc], gb[..., nc:])

