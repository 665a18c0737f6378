"""The eval forward of a factorized frontend conv (models/factorized.py's
`FactorizedNormConv`), fused into one CUDA kernel (csrc/objconv.cu).

For coverage maps cov (B, K, H, W) (K = frames * objects), the per-sample
projected kernels wk (B, K, 9, F), the image img (B, H, W, C) and the image
part of the normalised kernel w_img (F, C, 3, 3), all in the compute type
(bf16 or fp32):

    v = object_basis_conv(cov, wk) + conv(img, w_img).float()     (fp32)
    y = BatchNorm(v.to(kdt)) with running statistics,  or  (v + bias).to(kdt)
    y = leaky_relu(y, 0.2)

Three pieces live here, as in ops/denorm.py:

* the plain version, `objconv_plain`: the eager ops, the CPU path, the path
  of training and of every call the kernel does not take, and the kernel's
  oracle;
* the kernel's wrapper, `objconv_fused`: it checks types, shapes, strides
  and device, raises on anything the kernel does not take, and launches it.
  It never falls back;
* `route`, which tells `FactorizedNormConv.forward` whether the kernel
  computes a call: `denorm.route` itself (a CUDA tensor and no
  `ops.plain()` around the call, eval mode, running statistics or no
  subnorm, no gradient to take), so every eval call of the module on the
  card launches the kernel.

The kernel replaces no TPU kernel: XLA fused this chain on the TPU. It
rounds where the eager chain rounds; only the order of its fp32 sums
differs (tensor cores, or in fp32 compute and at other widths the CUDA
cores, against the fp32 `bmm`), which now and then flips one bf16 rounding
before the norm.
"""

from __future__ import annotations

from typing import Optional

import torch

from ag2video_torch.ops import _kernels, denorm
from ag2video_torch.ops.constants import LaunchCount

# Launches of the CUDA kernel, counted where the kernel is launched.
KERNEL_LAUNCHES = LaunchCount()

KS = 3  # the only kernel size the kernel takes
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# 'kernel' for a CUDA tensor outside `ops.plain()`, in eval mode, a
# BatchNorm on running statistics or no subnorm, and no gradient to take
# (the kernel has no backward); 'plain' (the eager ops) otherwise. On the
# 'kernel' route `objconv_fused` launches the kernel or raises: it never
# hands a call back to the eager ops.
route = denorm.route


def objconv_plain(cov: torch.Tensor, wk: torch.Tensor, img: torch.Tensor,
                  w_img: torch.Tensor, norm: Optional[torch.nn.Module],
                  bias: Optional[torch.Tensor], train: bool) -> torch.Tensor:
    """The eager chain of `FactorizedNormConv.forward`, in the compute type
    `wk.dtype`: the layout part in the object basis (fp32), the image conv
    in the compute type added in fp32, then the subnorm `norm` (its forward,
    with `train`) or the bias, then the leaky ReLU."""
    # models/ imports this module (models/factorized.py): import at call.
    from ag2video_torch.models.factorized import object_basis_conv
    from ag2video_torch.models.layers import conv2d_nhwc, leaky_relu_02

    kdt = wk.dtype
    ks = w_img.shape[-1]
    out = object_basis_conv(cov, wk, ks)
    out = out + conv2d_nhwc(img, w_img, None, dtype=kdt).float()
    y = (out + bias).to(kdt) if norm is None else norm(out.to(kdt), train)
    return leaky_relu_02(y)


def objconv_fused(cov: torch.Tensor, wk: torch.Tensor, img: torch.Tensor,
                  w_img: torch.Tensor, mean: Optional[torch.Tensor],
                  mul: Optional[torch.Tensor],
                  shift: Optional[torch.Tensor]) -> torch.Tensor:
    """Check the inputs, allocate the output and launch csrc/objconv.cu.

    cov (B, nF, O, H, W) or (B, K, H, W), each sample's maps contiguous (a
    window of frames sliced from a longer clip is taken in place); wk (B,
    K, 9, F), img (B, H, W, C) and w_img (F, C, 3, 3) contiguous; all four
    bf16 or all fp32 (the compute type). With `mean` and `mul` ((F,) fp32:
    the running mean and rsqrt(running_var + eps) * scale) the BatchNorm,
    else none; `shift` ((F,) fp32) its bias, or the conv's bias. Returns the
    leaky ReLU of the result, (B, H, W, F) in the compute type. No gradient
    may be required of any input."""
    kdt = cov.dtype
    if kdt not in KERNEL_DTYPES:
        raise TypeError(f"the objconv kernel takes float32/bfloat16 cov, got "
                        f"{kdt}")
    for name, t in (("wk", wk), ("img", img), ("w_img", w_img)):
        if t.dtype != kdt:
            raise TypeError(f"{name} is {t.dtype}, cov {kdt}: one type for "
                            f"the four")
    if shift is None:
        raise ValueError("the kernel adds a shift: the norm's bias or the "
                         "conv's")
    if (mean is None) != (mul is None):
        raise ValueError("give mean and mul together (the norm) or neither")
    stats = [t for t in (mean, mul, shift) if t is not None]
    if any(t.dtype != torch.float32 for t in stats):
        raise TypeError("mean, mul and shift must be float32")
    if cov.dim() == 5:
        B, nF, O, H, W = cov.shape
        K = nF * O
    elif cov.dim() == 4:
        B, K, H, W = cov.shape
    else:
        raise ValueError(f"cov {tuple(cov.shape)} is not (B, nF, O, H, W) "
                         f"or (B, K, H, W)")
    if wk.dim() != 4 or wk.shape[:3] != (B, K, KS * KS):
        raise ValueError(f"wk {tuple(wk.shape)} is not ({B}, {K}, "
                         f"{KS * KS}, F)")
    F_ = wk.shape[3]
    if img.dim() != 4 or img.shape[:3] != (B, H, W):
        raise ValueError(f"img {tuple(img.shape)} is not ({B}, {H}, {W}, C)")
    C = img.shape[3]
    if w_img.shape != (F_, C, KS, KS):
        raise ValueError(f"w_img {tuple(w_img.shape)} is not ({F_}, {C}, "
                         f"{KS}, {KS})")
    if F_ < 1 or K < 1 or C < 1:
        raise ValueError(f"the objconv kernel takes at least one feature, "
                         f"map and image channel; got F={F_}, K={K}, C={C}")
    if any(t.shape != (F_,) for t in stats):
        raise ValueError(f"mean, mul and shift must be ({F_},)")
    # Each sample's maps contiguous; the sample stride is free.
    if B < 1 or H < 1 or W < 1:
        raise ValueError(f"cov {tuple(cov.shape)} is empty")
    if not cov[0].is_contiguous():
        raise ValueError("cov must hold each sample's maps contiguously")
    for name, t in (("wk", wk), ("img", img), ("w_img", w_img),
                    *((n, t) for n, t in (("mean", mean), ("mul", mul),
                                          ("shift", shift)) if t is not None)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = cov.device
    if not (cov.is_cuda and all(t.device == dev
                                for t in (wk, img, w_img, *stats))):
        raise ValueError("the objconv kernel needs every input on one CUDA "
                         "device")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (cov, wk, img, w_img, *stats)):
        raise ValueError("the objconv kernel has no backward: call it with "
                         "no gradient to take")
    out = torch.empty(B, H, W, F_, dtype=kdt, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = _kernels.load("objconv").lib.ag_objconv_forward(
        cov.data_ptr(), cov.stride(0), wk.data_ptr(), img.data_ptr(),
        w_img.data_ptr(), ptr(mean), ptr(mul), ptr(shift), out.data_ptr(),
        B, K, H, W, F_, C, int(mean is not None), KERNEL_DTYPES[kdt],
        cov.get_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"objconv kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES.n += 1
    return out
