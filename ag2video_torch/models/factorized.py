"""Object-basis convolution over rasterized layouts (port of
ag2video_tpu/models/factorized.py).

The rasterized layout `seg = sum_o coverage_o (x) vecs_o` has rank <= O, so
a 3x3 conv of it is, by linearity,

    conv(seg, K)[y, x, f]
      = sum_o sum_{dy,dx} cov_o[y+dy, x+dx] * (K[dy, dx, :, f] . vecs_o)

the kernel projected through each object's vector, then contracted with
the 9 spatial shifts of the O coverage maps: a (H*W, 9*O) x (9*O, F)
product per sample instead of a (H*W, 9*C) x (9*C, F) one, and the dense
seg tensor never exists. The generator's two frontend convs (`flow_down_0`
and `conv_dim_in`) run this way in the default configuration.

`spectral_normalize` is this module's own power iteration, not flax
`SpectralNorm` (normalization.SpectralWeight): the eps is added to the
norm, `u` has shape (features,), sigma = v^T K u is taken after the
iteration, and no sigma is stored. Train mode (`train=True`) writes the
new `u` back and takes the gradient through sigma; otherwise nothing is
written, and where no gradient is taken the normalised kernel is cached
per weight version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ag2video_torch.models.layers import trunc_normal_
from ag2video_torch.models.normalization import (BatchNorm, split_norm,
                                                 subnorm_layer)
from ag2video_torch.ops import objconv


def spectral_normalize(kernel: torch.Tensor, u: torch.Tensor,
                       n_steps: int = 1, eps: float = 1e-12
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Power-iteration spectral normalization of a kernel whose last axis
    is the output features (HWIO, or (in, out)).

    kernel (..., C_out) is viewed as (K, C_out); u: (C_out,). Returns
    (kernel / sigma, new_u), computed in fp32; u and v carry no gradient,
    so the kernel's gradient flows through sigma and the division only.
    """
    k2 = kernel.reshape(-1, kernel.shape[-1]).float()
    u = u.float()
    with torch.no_grad():
        kd = k2.detach()
        for _ in range(n_steps):
            v = kd @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = kd.t() @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        v = kd @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
    sigma = torch.einsum("k,kf,f->", v, k2, u)
    return kernel / sigma.to(kernel.dtype), u


def shifted_stack(cov: torch.Tensor, ks: int = 3) -> torch.Tensor:
    """(B, K, H, W) -> (B, K, ks*ks, H, W): SAME-padded spatial shifts
    (the im2col of a ks x ks conv applied to single-channel maps), shift
    s = dy*ks + dx, as one `F.unfold`."""
    B, K, H, W = cov.shape
    return F.unfold(cov, ks, padding=ks // 2).reshape(B, K, ks * ks, H, W)


def object_basis_conv(cov: torch.Tensor, wk: torch.Tensor,
                      ks: int = 3) -> torch.Tensor:
    """sum_k conv2d(cov_k, wk_k) -> (B, H, W, F) float32.

    cov (B, K, H, W) coverage maps (K = frames * objects); wk
    (B, K, ks*ks, F) per-object projected kernels. The operands are taken
    to fp32 and contracted by one batched matmul, as the JAX einsum
    accumulates and returns fp32 (`preferred_element_type`).
    """
    B, K, H, W = cov.shape
    cs = shifted_stack(cov.float(), ks).reshape(B, K * ks * ks, H * W)
    out = torch.bmm(cs.transpose(1, 2), wk.float().reshape(B, K * ks * ks, -1))
    return out.reshape(B, H, W, -1)


class FactorizedNormConv(nn.Module):
    """NormConv applied to [layout windows, dense image channels], the layout
    part consumed in the object basis.

    One kernel `weight` (OIHW, (features, n_frames*seg_dim + img_ch, ks, ks),
    the dense layer's shape) spectrally normalised as a whole, then the
    per-(frame, object) kernel projection for the layout channels, a dense
    3x3 SAME conv for the image channels, and the subnorm (submodule
    `norm`: BatchNorm or the instance norm), or a bias when the norm has no
    subnorm; then the leaky ReLU (0.2) that both of the generator's uses
    apply (the JAX module leaves it to its caller).
    """

    def __init__(self, features: int, norm: str, seg_dim: int, n_frames: int,
                 img_ch: int, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        spectral, subnorm, has_subnorm = split_norm(norm)
        self.seg_dim, self.n_frames = seg_dim, n_frames
        self.ks, self.dtype = kernel_size, dtype
        k = kernel_size
        self.weight = nn.Parameter(
            torch.empty(features, n_frames * seg_dim + img_ch, k, k))
        if spectral:
            self.register_buffer("u", torch.zeros(features))
        else:
            self.u = None
        self.norm = subnorm_layer(subnorm, features, dtype) \
            if has_subnorm else None
        self.bias = None if has_subnorm else \
            nn.Parameter(torch.zeros(features))
        self._cache = None

    def init_(self, g: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        trunc_normal_(self.weight, math.sqrt(1.0 / (i * kh * kw)), g)
        with torch.no_grad():
            if self.u is not None:
                self.u.copy_(torch.randn(o, generator=g) / math.sqrt(o))
            if self.bias is not None:
                self.bias.zero_()
        self._cache = None

    def normalized_weight(self, train: bool = False) -> torch.Tensor:
        """The OIHW kernel divided by sigma (spectral_normalize on its HWIO
        view). `train` stores the new `u`; without it and without a gradient
        to take, computed once per version of the kernel and `u`."""
        if self.u is None:
            return self.weight
        w = self.weight
        if train or (torch.is_grad_enabled() and w.requires_grad):
            kn, new_u = spectral_normalize(w.permute(2, 3, 1, 0), self.u)
            if train:
                with torch.no_grad():
                    self.u.copy_(new_u)
            return kn.permute(3, 2, 0, 1)
        key = (w.data_ptr(), w._version, self.u.data_ptr(), self.u._version)
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        with torch.inference_mode(False), torch.no_grad():
            kn, _ = spectral_normalize(w.detach().permute(2, 3, 1, 0), self.u)
            kn = kn.permute(3, 2, 0, 1)
        self._cache = (key, kn)
        return kn

    def forward(self, cov_win: torch.Tensor, vecs_win: torch.Tensor,
                img: torch.Tensor, train: bool = False) -> torch.Tensor:
        """cov_win (B, n_frames, O, H, W), vecs_win (B, n_frames, O,
        seg_dim), img (B, H, W, img_ch) -> (B, H, W, features), then the
        leaky ReLU that follows both of the frame loop's factorized convs.
        Where `objconv.route` says so (CUDA tensors outside `ops.plain()`,
        eval mode, a BatchNorm on running statistics or no subnorm, no
        gradient to take) one launch of csrc/objconv.cu computes the
        contraction, the image conv, the norm and the activation; otherwise
        the eager ops (`objconv.objconv_plain`)."""
        B, nF, O, H, W = cov_win.shape
        ks = self.ks
        seg_ch = self.n_frames * self.seg_dim
        kernel_n = self.normalized_weight(train)
        kdt = self.dtype or kernel_n.dtype
        kernel_n = kernel_n.to(kdt)

        # Layout part in the object basis: per-(frame, object) kernels
        # (B, nF, O, ks*ks, F), axis 1 of the OIHW kernel split at seg_ch.
        k_seg = kernel_n[:, :seg_ch].reshape(
            -1, self.n_frames, self.seg_dim, ks * ks)
        wk = torch.einsum("fnds,bnod->bnosf", k_seg, vecs_win.to(kdt))
        wk = wk.reshape(B, nF * O, ks * ks, -1)
        cov = cov_win.to(kdt)
        w_img = kernel_n[:, seg_ch:]
        img = img.to(kdt)

        # The kernel's norms: a BatchNorm (running statistics in eval mode)
        # with its bias, or none.
        norm = self.norm
        running = norm is None or (isinstance(norm, BatchNorm)
                                   and norm.bias is not None)
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (wk, cov, img, w_img))
        if objconv.route(cov.device.type, train, running,
                         needs_grad) == "kernel":
            if norm is None:
                mean = mul = None
                shift = self.bias.float().contiguous()
            else:
                mean, mul, shift = norm.eval_affine()
            return objconv.objconv_fused(
                cov, wk, img.contiguous(), w_img.contiguous(), mean, mul,
                shift)
        return objconv.objconv_plain(cov.reshape(B, nF * O, H, W), wk, img,
                                     w_img, norm, self.bias, train)
