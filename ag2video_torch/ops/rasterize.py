"""Box -> dense feature-map rasterization (port of
ag2video_tpu/ops/rasterize.py).

Grid-sampling a constant tile through each box's inverse affine grid has the
closed form `out[y, x, d] = sum_o vecs[o, d] * wy[o, y] * wx[o, x]`, with w a
unit-width trapezoid ramp at each tile edge (see the JAX module's docstring).

Three pieces live here:

* the plain version, `box_coverage` + an fp32 einsum, which the CPU tests use
  and which serves as the oracle on the card;
* the CUDA kernel's `torch.autograd.Function` (forward: csrc/rasterize.cu;
  backward: autograd of the plain closed form, `dmask` = None, mirroring the
  JAX kernel's `_bwd`);
* the dispatch, `boxes_to_layout_batch`: where `_kernels.use_kernel` says so
  (a CUDA tensor, no `ops.plain()` around the call) it launches the kernel
  or raises, and never falls back; otherwise it takes the plain version.
  The kernel takes every call: its autograd.Function has a backward.

Beside them, two rasterizers that are XLA code in the JAX package and plain
PyTorch here: `boxes_to_mask` (the hard union of the boxes) and
`masks_to_layout` (per-object soft masks sampled into their boxes).

The kernel replaces the Pallas TPU kernel
ag2video_tpu/ops/pallas/rasterize_kernel.py (`_kernel`, via
`boxes_to_layout_pallas`). On the H100 it is bound by its output write. For
bf16 vecs it contracts on the tensor cores (mma.sync), the fp32 coverage
split exactly into three bf16 terms, and streams the (N, H, W, D) output
with 16-byte stores from a persistent grid; fp32 vecs take a CUDA-core
kernel. The coverage never reaches memory (csrc/rasterize.cu says more).
"""

from __future__ import annotations

from typing import Optional

import torch

from ag2video_torch.ops import _kernels
from ag2video_torch.ops.constants import LaunchCount, cached
from ag2video_torch.ops.sampling import grid_sample_2d, linspace01

TILE = 8  # reference tile size, models/layout.py:52


# Launches of the CUDA kernel, counted where the kernel is launched.
KERNEL_LAUNCHES = LaunchCount()
# Calls of the plain version through `boxes_to_layout_batch`.
PLAIN_CALLS = LaunchCount()


def _centers(S: int, device) -> torch.Tensor:
    """Pixel centres in [0, 1]: i / (S - 1), as the TPU kernel computes them.

    The divisor is a tensor on purpose: on CUDA, PyTorch turns division by
    a Python scalar into multiplication by its reciprocal, which is one ulp
    off i / (S - 1) for some i, and the ramps (slope 7 / w) amplify that
    ulp to ~1e-5 in the output. The CUDA kernel divides, so must this.
    Built once per size and device (ops/constants.py).
    """
    return cached(("centers", S), device, lambda: (
        torch.arange(S, dtype=torch.float32, device=device)
        / torch.tensor(float(max(S - 1, 1)), device=device)))


def box_coverage(boxes: torch.Tensor, H: int, W: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-object soft coverage maps.

    boxes: (..., O, 4) xywh in [0, 1]; mask: (..., O) validity.
    Returns (..., O, H, W) float32 coverage in [0, 1].
    """
    boxes = boxes.float()
    x0, y0 = boxes[..., 0:1], boxes[..., 1:2]
    ww, hh = boxes[..., 2:3], boxes[..., 3:4]
    xs = _centers(W, boxes.device)
    ys = _centers(H, boxes.device)

    # Degenerate boxes rasterize to nothing (coverage := 0).
    safe_ww = torch.where(ww == 0, torch.ones_like(ww), ww)
    safe_hh = torch.where(hh == 0, torch.ones_like(hh), hh)

    t1 = float(TILE - 1)
    px = (xs - x0) / safe_ww * t1  # (..., O, W)
    py = (ys - y0) / safe_hh * t1  # (..., O, H)
    wx = torch.clamp(torch.minimum(px + 1.0, float(TILE) - px), 0.0, 1.0)
    wy = torch.clamp(torch.minimum(py + 1.0, float(TILE) - py), 0.0, 1.0)

    valid = (ww != 0) & (hh != 0)
    if mask is not None:
        valid = valid & (mask[..., None] > 0)
    wx = torch.where(valid, wx, torch.zeros_like(wx))
    return wy[..., :, None] * wx[..., None, :]


def boxes_to_layout_plain(vecs: torch.Tensor, boxes: torch.Tensor, H: int,
                          W: int, mask: torch.Tensor) -> torch.Tensor:
    """The closed form: coverage einsum in fp32, cast to vecs.dtype.

    vecs (..., O, D), boxes (..., O, 4), mask (..., O) -> (..., H, W, D).
    """
    cov = box_coverage(boxes, H, W, mask)
    out = torch.einsum("...ohw,...od->...hwd", cov, vecs.float())
    return out.to(vecs.dtype)


def _kernel_forward(vecs: torch.Tensor, boxes: torch.Tensor,
                    mask: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Check the inputs, allocate the output and launch csrc/rasterize.cu.

    vecs (N, O, D) float32|bfloat16 contiguous; boxes (N, O, 4); mask (N, O).
    """
    if not vecs.is_cuda:
        raise ValueError("the CUDA rasterizer needs CUDA tensors")
    if vecs.dtype == torch.float32:
        dtype_code = 0
    elif vecs.dtype == torch.bfloat16:
        dtype_code = 1
    else:
        raise TypeError(f"rasterizer kernel takes float32/bfloat16 vecs, "
                        f"got {vecs.dtype}")
    if vecs.dim() != 3:
        raise ValueError(f"vecs must be (N, O, D), got {tuple(vecs.shape)}")
    if not vecs.is_contiguous():
        raise ValueError("vecs must be contiguous")
    N, O, D = vecs.shape
    if tuple(boxes.shape) != (N, O, 4) or tuple(mask.shape) != (N, O):
        raise ValueError(f"boxes {tuple(boxes.shape)} / mask "
                         f"{tuple(mask.shape)} do not match vecs {(N, O, D)}")
    if boxes.device != vecs.device or mask.device != vecs.device:
        raise ValueError("vecs, boxes and mask must be on one device")
    if H < 1 or W < 1 or N > 65535 or (H + 3) // 4 > 65535:
        raise ValueError(f"unsupported grid: N={N} H={H} W={W}")
    out = torch.empty((N, H, W, D), dtype=vecs.dtype, device=vecs.device)
    if out.numel() == 0:
        return out
    # Small per-object inputs, converted as the TPU kernel's wrapper does.
    boxes = boxes.to(torch.float32).contiguous()
    mask = mask.to(torch.float32).contiguous()

    lib = _kernels.load("rasterize").lib
    smem = lib.ag_rasterize_smem_bytes(O, D, W, dtype_code)
    if smem > 227 * 1024:
        raise ValueError(f"O={O} x W={W} needs {smem} bytes of shared "
                         f"memory; the kernel takes at most 227 KiB")
    with torch.cuda.device(vecs.device):
        stream = torch.cuda.current_stream(vecs.device).cuda_stream
        err = lib.ag_rasterize_forward(
            vecs.data_ptr(), boxes.data_ptr(), mask.data_ptr(),
            out.data_ptr(), N, O, D, H, W, dtype_code, stream)
    if err != 0:
        raise RuntimeError(f"rasterize kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES.n += 1
    return out


class RasterizeFunction(torch.autograd.Function):
    """Kernel forward; backward is autograd of the plain closed form
    (dvecs, dboxes; dmask = None), as the TPU kernel's custom VJP does."""

    @staticmethod
    def forward(ctx, vecs, boxes, mask, H, W):
        ctx.save_for_backward(vecs, boxes, mask)
        ctx.hw = (H, W)
        return _kernel_forward(vecs, boxes, mask, H, W)

    @staticmethod
    def backward(ctx, g):
        vecs, boxes, mask = ctx.saved_tensors
        H, W = ctx.hw
        with torch.enable_grad():
            v = vecs.detach().requires_grad_(ctx.needs_input_grad[0])
            b = boxes.detach().requires_grad_(ctx.needs_input_grad[1])
            out = boxes_to_layout_plain(v, b, H, W, mask)
            wrt = [t for t in (v, b) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
        dv = next(grads) if ctx.needs_input_grad[0] else None
        db = next(grads) if ctx.needs_input_grad[1] else None
        return dv, db, None, None, None


def boxes_to_layout_batch(vecs: torch.Tensor, boxes: torch.Tensor, H: int,
                          W: Optional[int] = None,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Batched rasterization over arbitrary leading dims.

    vecs: (..., O, D); boxes: (..., O, 4); mask: (..., O).
    Returns (..., H, W, D) in vecs.dtype.

    The CUDA kernel on a CUDA tensor (or it raises); the closed form on the
    CPU, and on the card inside `ops.plain()` (the kernel's oracle).
    """
    if W is None:
        W = H
    if mask is None:
        mask = (boxes != 0).any(dim=-1)
    if not _kernels.use_kernel(vecs.device.type):
        PLAIN_CALLS.n += 1
        return boxes_to_layout_plain(vecs, boxes, H, W, mask)

    lead = vecs.shape[:-2]
    O, D = vecs.shape[-2], vecs.shape[-1]
    n = 1
    for s in lead:
        n *= s
    mask = torch.broadcast_to(mask, boxes.shape[:-1])
    out = RasterizeFunction.apply(
        vecs.reshape(n, O, D), boxes.reshape(n, O, 4), mask.reshape(n, O),
        H, W)
    return out.reshape(*lead, H, W, D)


# One sample, vecs (O, D), boxes (O, 4), mask (O,) -> (H, W, D): the batched
# dispatch with no leading dims (the JAX package's single-sample name).
boxes_to_layout = boxes_to_layout_batch


def boxes_to_mask(boxes: torch.Tensor, H: int, W: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard 0/1 union of boxes (..., O, 4) -> (..., H, W) fp32: each box
    covers the half-open pixel range [floor(x0 * W), floor(x0 * W) +
    floor(w * W)) and likewise in y; masked objects cover nothing."""
    if mask is None:
        mask = (boxes != 0).any(dim=-1)
    boxes = boxes.float()
    x0 = torch.floor(boxes[..., 0:1] * W)
    y0 = torch.floor(boxes[..., 1:2] * H)
    x1 = x0 + torch.floor(boxes[..., 2:3] * W)
    y1 = y0 + torch.floor(boxes[..., 3:4] * H)
    xs = torch.arange(W, dtype=torch.float32, device=boxes.device)
    ys = torch.arange(H, dtype=torch.float32, device=boxes.device)
    inx = ((xs >= x0) & (xs < x1) & (mask[..., None] > 0)).float()
    iny = ((ys >= y0) & (ys < y1)).float()
    return (iny[..., :, None] * inx[..., None, :]).amax(dim=-3)


def masks_to_layout(vecs: torch.Tensor, boxes: torch.Tensor,
                    masks: torch.Tensor, H: int, W: Optional[int] = None,
                    obj_mask: Optional[torch.Tensor] = None,
                    test_mode: bool = False) -> torch.Tensor:
    """Per-object soft masks, placed in their boxes and scaled by vecs.

    vecs (O, D); boxes (O, 4) xywh; masks (O, M, M). Returns (H, W, D).

    Each mask is sampled (align_corners=True, zeros padding) through its
    box's inverse affine grid. Train mode sums the O layers. Test mode
    composites: objects in ascending order of mass (the sum of the layer),
    equal masses in index order (a stable sort, as `jnp.argsort` is), each
    claiming the pixels where its sampled mask exceeds 0.5 and no earlier
    object has claimed.
    """
    if W is None:
        W = H
    O = masks.shape[0]
    if obj_mask is None:
        obj_mask = (boxes != 0).any(dim=-1)
    x0, y0, ww, hh = (boxes[:, i:i + 1] for i in range(4))
    xs = linspace01(W, boxes.device)[None, :]
    ys = linspace01(H, boxes.device)[None, :]
    # Tensors, not Python scalars: the JAX package divides by these.
    safe_ww = torch.where(ww == 0, torch.ones_like(ww), ww)
    safe_hh = torch.where(hh == 0, torch.ones_like(hh), hh)
    gx = ((xs - x0) / safe_ww) * 2.0 - 1.0  # (O, W)
    gy = ((ys - y0) / safe_hh) * 2.0 - 1.0  # (O, H)
    grid = torch.stack([gx[:, None, :].expand(O, H, W),
                        gy[:, :, None].expand(O, H, W)], dim=-1)
    sampled = grid_sample_2d(masks[..., None].float(), grid,
                             align_corners=True, padding_mode="zeros")[..., 0]
    sampled = sampled * (obj_mask[:, None, None] > 0)
    samples = sampled[..., None] * vecs[:, None, None, :]  # (O, H, W, D)
    if not test_mode:
        return samples.sum(dim=0)

    mass = samples.sum(dim=(1, 2, 3))
    hard = (sampled > 0.5).float()
    claimed = torch.zeros(H, W, device=vecs.device)
    out = torch.zeros(H, W, vecs.shape[-1], device=vecs.device)
    for o in torch.argsort(mass, stable=True).tolist():
        add = (1.0 - claimed) * hard[o]
        out = out + samples[o] * add[..., None]
        claimed = claimed + add
    return out
