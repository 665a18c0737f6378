"""The eval chain of a SPADE norm whose param-free norm applies running
statistics, fused into one CUDA kernel (csrc/denorm.cu).

For x (..., C) and the norm's merged conditioning output gb (..., 2C),
gamma = gb[..., :C] and beta = gb[..., C:]:

    y = ((x - mean) * mul).to(x.dtype) * (1 + gamma) + beta
    y = leaky_relu(y, 0.2) if act else y

with mean the running mean and mul = rsqrt(running_var + eps) in fp32, as
`normalization.normalize` computes them with `train=False` and no scale.

Three pieces live here:

* the plain version, `denorm_plain`: the eager ops, one launch each on the
  card; the CPU path and the kernel's oracle;
* the kernel's wrapper, `denorm_fused`: it checks types, shapes,
  contiguity and device, raises on anything the kernel does not take, and
  launches it. It never falls back;
* `route`, which tells `SPADE.denorm` (models/normalization.py) whether
  the kernel computes a call: the kernel's conditions (the mode, the
  norm's kind, grad mode) put to the one rule of `_kernels.use_kernel`
  (the device, and no `ops.plain()` around the call).

The kernel replaces no TPU kernel: XLA fused this chain on the TPU. It
rounds where the eager chain rounds, so its output is bit-equal to
`denorm_plain` on the card; it moves x, gamma, beta and y once (8 bytes
per bf16 element) where the eager chain moves about 48.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ag2video_torch.ops import _kernels
from ag2video_torch.ops.constants import LaunchCount

NEG_SLOPE = 0.2  # the SPADE stack's leaky ReLU (models/layers.leaky_relu_02)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel, counted where the kernel is launched.
KERNEL_LAUNCHES = LaunchCount()


def denorm_plain(x: torch.Tensor, gb: torch.Tensor, mean: torch.Tensor,
                 mul: torch.Tensor, act: bool) -> torch.Tensor:
    """The eager chain: `normalize`'s fp32 (x - mean) * mul cast to x's
    type, then SPADE's `* (1 + gamma) + beta` and the stack's leaky ReLU."""
    C = x.shape[-1]
    y = ((x.float() - mean) * mul).to(x.dtype) * (1 + gb[..., :C]) \
        + gb[..., C:]
    return F.leaky_relu(y, negative_slope=NEG_SLOPE) if act else y


def route(device_type: str, train: bool, running_stats: bool,
          needs_grad: bool) -> str:
    """'kernel' where `_kernels.use_kernel` gives the call to the kernel
    (a CUDA tensor, no `ops.plain()` around it) and the kernel takes it:
    eval mode, normalised by running statistics (a batch param-free norm:
    the instance and group norms take per-sample ones), with no gradient
    to take (the kernel has no backward); 'plain' (the eager ops)
    otherwise. On the 'kernel' route `denorm_fused` launches the kernel or
    raises: it never hands a call back to the eager ops."""
    takes = not train and running_stats and not needs_grad
    return "kernel" if _kernels.use_kernel(device_type, takes) else "plain"


def denorm_fused(x: torch.Tensor, gb: torch.Tensor, mean: torch.Tensor,
                 mul: torch.Tensor, act: bool) -> torch.Tensor:
    """Check the inputs, allocate the output and launch csrc/denorm.cu.

    x (..., C) float32 | bfloat16 and gb (..., 2C) of x's type, mean and
    mul (C,) float32, all contiguous and on one CUDA device; no gradient
    may be required of x or gb."""
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the denorm kernel takes float32/bfloat16 x, got "
                        f"{x.dtype}")
    if gb.dtype != x.dtype:
        raise TypeError(f"gb is {gb.dtype}, x {x.dtype}: one type for both")
    if mean.dtype != torch.float32 or mul.dtype != torch.float32:
        raise TypeError("mean and mul must be float32")
    if x.dim() < 1:
        raise ValueError("x needs a channel axis")
    C = x.shape[-1]
    if gb.shape != x.shape[:-1] + (2 * C,):
        raise ValueError(f"gb {tuple(gb.shape)} is not x "
                         f"{tuple(x.shape)} with 2C channels")
    if mean.shape != (C,) or mul.shape != (C,):
        raise ValueError(f"mean {tuple(mean.shape)} / mul "
                         f"{tuple(mul.shape)} are not ({C},)")
    for name, t in (("x", x), ("gb", gb), ("mean", mean), ("mul", mul)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (x.is_cuda and gb.device == x.device and mean.device == x.device
            and mul.device == x.device):
        raise ValueError("the denorm kernel needs x, gb, mean and mul on "
                         "one CUDA device")
    if torch.is_grad_enabled() and (x.requires_grad or gb.requires_grad):
        raise ValueError("the denorm kernel has no backward: call it with "
                         "no gradient to take")
    y = torch.empty_like(x)
    rows = x.numel() // C if C else 0
    if rows == 0:
        return y
    vec = 16 // x.element_size()
    if C % vec or any(t.data_ptr() % 16 for t in (x, gb, mean, mul, y)):
        vec = 1
    if rows * C // vec >= 2 ** 31:
        raise ValueError(f"x has {x.numel()} elements: too many for one "
                         f"launch")
    err = _kernels.load("denorm").lib.ag_denorm_forward(
        x.data_ptr(), gb.data_ptr(), mean.data_ptr(), mul.data_ptr(),
        y.data_ptr(), rows, C, KERNEL_DTYPES[x.dtype], vec, int(act),
        x.get_device(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"denorm kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES.n += 1
    return y
