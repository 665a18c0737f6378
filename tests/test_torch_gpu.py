"""Card-only tests of the port's CUDA kernels (marker `gpu`).

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


@pytest.mark.gpu
@pytest.mark.parametrize("N,O,D,H,W,dtype", [
    (3, 6, 128, 32, 32, torch.float32),
    (2, 13, 400, 48, 48, torch.float32),
    (2, 20, 30, 20, 24, torch.float32),     # O > 16, D % 4 != 0
    (16, 11, 512, 256, 256, torch.bfloat16),  # the dense generator's shape
])
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
