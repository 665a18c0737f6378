"""Card-only tests of the port's CUDA kernels, and of an op whose CUDA
backward the port works around (marker `gpu`).

They skip without a CUDA card. This file imports neither jax nor the JAX
package, so it also runs where JAX is absent; tests/conftest.py imports jax,
so there run it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from ag2video_torch.ops import rasterize as tr

F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: kernel and plain round fp32 sums taken in another order, so an
# output may differ by one bf16 rounding (at most 2^-7 relative).
BF16_TOL = dict(rtol=1e-2, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, O, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    vecs = torch.randn(N, O, D, generator=g).to(dtype)
    boxes = torch.cat([torch.rand(N, O, 2, generator=g) * 1.1 - 0.2,
                       torch.rand(N, O, 2, generator=g) * 0.65 + 0.05], -1)
    boxes[0, 0, 2] = 0.0  # a zero-width box
    mask = (torch.rand(N, O, generator=g) > 0.25).float()
    return vecs.to(device), boxes.to(device), mask.to(device)


# fp32 takes the CUDA-core kernel, bf16 the tensor-core kernel (16 objects
# per K step, 64-channel chunks, 16-pixel groups, 16-byte stores when
# D % 8 == 0).
SHAPES = [
    (3, 6, 128, 32, 32, torch.float32),
    (2, 13, 400, 48, 48, torch.float32),
    (2, 20, 30, 20, 24, torch.float32),     # O > 16, D % 4 != 0
    (16, 11, 512, 256, 256, torch.bfloat16),  # the dense generator's shape
    (1, 11, 512, 256, 256, torch.bfloat16),   # N = 1
    (2, 16, 512, 64, 64, torch.bfloat16),     # O = one full K step
    (2, 17, 512, 64, 64, torch.bfloat16),     # O = 17: a second K step
    (2, 11, 520, 40, 48, torch.bfloat16),     # D past a 64-channel chunk
    (2, 11, 100, 37, 50, torch.bfloat16),     # H, W ragged; D % 8 != 0
    (2, 20, 30, 20, 24, torch.bfloat16),      # few channels, O > 16
]


@pytest.mark.gpu
@pytest.mark.parametrize("N,O,D,H,W,dtype", SHAPES)
def test_kernel_matches_plain(cuda, N, O, D, H, W, dtype):
    vecs, boxes, mask = _inputs(N, O, D, dtype, cuda)
    before = tr.KERNEL_LAUNCHES.n
    k = tr.boxes_to_layout_batch(vecs, boxes, H, W, mask=mask)
    torch.cuda.synchronize()
    assert tr.KERNEL_LAUNCHES.n == before + 1
    p = tr.boxes_to_layout_batch(vecs, boxes, H, W, mask=mask,
                                 backend="plain")
    assert k.dtype == dtype and k.shape == (N, H, W, D)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(k.float(), p.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_masked_frame_is_zero(cuda, dtype):
    vecs, boxes, mask = _inputs(3, 11, 512, dtype, cuda, seed=2)
    mask[1] = 0.0
    k = tr.boxes_to_layout_batch(vecs, boxes, 40, 40, mask=mask)
    torch.cuda.synchronize()
    assert bool((k[1] == 0).all())
    p = tr.boxes_to_layout_batch(vecs, boxes, 40, 40, mask=mask,
                                 backend="plain")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(k.float(), p.float(), **tol)


@pytest.mark.gpu
def test_kernel_gradients_match_plain(cuda):
    vecs, boxes, mask = _inputs(3, 6, 128, torch.float32, cuda, seed=1)
    g = torch.randn(3, 32, 32, 128, device=cuda)
    grads = []
    for backend in ("auto", "plain"):
        v = vecs.clone().requires_grad_(True)
        b = boxes.clone().requires_grad_(True)
        out = tr.boxes_to_layout_batch(v, b, 32, mask=mask, backend=backend)
        grads.append(torch.autograd.grad((out * g).sum(), (v, b)))
    torch.testing.assert_close(grads[0][0], grads[1][0], **F32_TOL)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    vecs, boxes, mask = _inputs(2, 3, 8, torch.float16, cuda)
    with pytest.raises(TypeError):
        tr.boxes_to_layout_batch(vecs, boxes, 8, mask=mask)
    wide = torch.randn(2, 3, 16, device=cuda)[..., ::2]
    with pytest.raises(ValueError):
        tr.boxes_to_layout_batch(wide, boxes, 8, mask=mask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_avg_pool_3x3s2_gradient_matches_cpu(cuda, dtype):
    """The multiscale discriminators' downsample: on CUDA, avg_pool2d's
    backward with padding on a channels_last input is wrong (PyTorch 2.11),
    so the port pools a contiguous NCHW copy."""
    from ag2video_torch.models.layers import avg_pool_3x3s2

    x0 = torch.randn(2, 3, 33, 40, 12, generator=torch.Generator()
                     .manual_seed(4)).to(dtype)
    r = torch.randn(2, 3, 17, 20, 12, generator=torch.Generator()
                    .manual_seed(5)).to(dtype)
    grads = []
    for dev in ("cpu", cuda):
        x = x0.to(dev).requires_grad_(True)
        y = avg_pool_3x3s2(x)
        grads.append(torch.autograd.grad((y * r.to(dev)).sum(), x)[0])
    got, want = grads[1].cpu().double(), grads[0].double()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32_TOL)
    else:
        # bf16: each side rounds the window sums in its own order, and
        # sums that cancel lose every bit, so the bound is on the whole:
        # rel-L2 within a few bf16 roundings (the fault gives ~1).
        assert float((got - want).norm() / want.norm()) <= 1e-2
