"""The factorized frontend conv's eval chain (ops/objconv.py,
FactorizedNormConv.forward) on the CPU.

The fused CUDA kernel runs only on the card (tests/test_torch_gpu.py). Here:
the plain chain is the module's former forward and leaky ReLU, bit for bit;
the dispatch gives today's results on the CPU in eval and train mode and
with a gradient to take; the route is chosen by device, mode, norm kind,
grad mode and the `ops.plain()` switch alone; the module hands the kernel
inputs it takes, in bf16 and fp32 compute and at any width, whose (mean,
mul, shift) give the plain chain's norm; the cached norm affine follows
the buffers; and the wrapper refuses what the kernel does not take before
it looks for a card.
"""

import contextlib
import copy

import pytest
import torch

from ag2video_torch.models.factorized import (FactorizedNormConv,
                                              object_basis_conv)
from ag2video_torch.models.layers import conv2d_nhwc, leaky_relu_02
from ag2video_torch.models.normalization import BatchNorm
from ag2video_torch import ops
from ag2video_torch.ops import _kernels, denorm
from ag2video_torch.ops import objconv as oc
from ag2video_torch.weights import init_params

BF16, F32 = torch.bfloat16, torch.float32


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def assert_bit_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(bits(a), bits(b))


def make_conv(norm: str, F: int, dtype, seg_dim=8, nF=2, img_ch=3,
              seed=0) -> FactorizedNormConv:
    conv = init_params(FactorizedNormConv(F, norm, seg_dim, nF, img_ch,
                                          dtype=dtype), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        if conv.norm is not None and hasattr(conv.norm, "running_mean"):
            conv.norm.running_mean.copy_(torch.randn(F, generator=g) * 0.1)
            conv.norm.running_var.uniform_(0.5, 2.0, generator=g)
            conv.norm.weight.copy_(1 + 0.2 * torch.randn(F, generator=g))
            conv.norm.bias.copy_(0.1 * torch.randn(F, generator=g))
        if conv.bias is not None:
            conv.bias.copy_(0.1 * torch.randn(F, generator=g))
    return conv


def make_window(B, nF, O, D, H, W, img_ch, dtype, seed=2, T=4):
    """Coverage sliced from a (B, T, O, H, W) clip, as the frame loop
    slices it (each sample's window contiguous, the sample stride T's)."""
    g = torch.Generator().manual_seed(seed)
    cov = (torch.rand(B, T, O, H, W, generator=g) > 0.6).to(dtype)
    cov = cov[:, 1:1 + nF]
    vecs = torch.randn(B, nF, O, D, generator=g).to(dtype)
    img = torch.randn(B, H, W, img_ch, generator=g)
    return cov, vecs, img


def former_forward(conv: FactorizedNormConv, cov_win, vecs_win, img, train):
    """FactorizedNormConv.forward as it was before the dispatch."""
    B, nF, O, H, W = cov_win.shape
    ks = conv.ks
    seg_ch = conv.n_frames * conv.seg_dim
    kernel_n = conv.normalized_weight(train)
    kdt = conv.dtype or kernel_n.dtype
    kernel_n = kernel_n.to(kdt)
    k_seg = kernel_n[:, :seg_ch].reshape(-1, conv.n_frames, conv.seg_dim,
                                         ks * ks)
    wk = torch.einsum("fnds,bnod->bnosf", k_seg, vecs_win.to(kdt))
    wk = wk.reshape(B, nF * O, ks * ks, -1)
    cov = cov_win.reshape(B, nF * O, H, W).to(kdt)
    out = object_basis_conv(cov, wk, ks)
    out = out + conv2d_nhwc(img.to(kdt), kernel_n[:, seg_ch:], None,
                            dtype=kdt).float()
    if conv.norm is None:
        return (out + conv.bias).to(kdt)
    return conv.norm(out.to(kdt), train)


NORMS = ["spectralsyncbatch", "spectralnone", "syncbatch"]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("size", [32, 64])
def test_dispatch_on_cpu_is_the_former_forward(size, dtype, norm, train):
    """The module's forward is its former forward and the leaky ReLU, bit
    for bit, at 32x32 and 64x64, fp32 and bf16 compute, with a BatchNorm
    and with the bias alone; in train mode the state moves alike."""
    conv = make_conv(norm, 32, dtype)
    before = copy.deepcopy(conv)
    cov, vecs, img = make_window(2, 2, 3, 8, size, size, 3, dtype)
    with torch.no_grad():
        got = conv(cov, vecs, img, train)
        want = leaky_relu_02(former_forward(before, cov, vecs, img, train))
        assert_bit_equal(got, want)
    for (k, a), b in zip(conv.state_dict().items(),
                         before.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("norm", ["spectralsyncbatch", "spectralinstance"])
def test_dispatch_keeps_gradients_on_cpu(norm):
    conv = make_conv(norm, 32, F32)
    ref = copy.deepcopy(conv)
    cov, vecs, img = make_window(2, 2, 3, 8, 12, 10, 3, F32)
    vecs.requires_grad_(True)
    gv, = torch.autograd.grad(conv(cov, vecs, img, False).sum(), (vecs,))
    v2 = vecs.detach().requires_grad_(True)
    want, = torch.autograd.grad(
        leaky_relu_02(former_forward(ref, cov, v2, img, False)).sum(), (v2,))
    assert torch.equal(gv, want)


# (device, train, running stats, needs grad, inside ops.plain()) -> route
ROUTES = [
    (("cuda", False, True, False, False), "kernel"),
    (("cpu", False, True, False, False), "plain"),
    (("meta", False, True, False, False), "plain"),
    (("cuda", True, True, False, False), "plain"),
    (("cuda", False, False, False, False), "plain"),
    (("cuda", False, True, True, False), "plain"),
    (("cuda", True, False, True, False), "plain"),
    (("cuda", False, True, False, True), "plain"),
]


@pytest.mark.parametrize("facts,want", ROUTES)
def test_route(facts, want):
    *facts, switched = facts
    with ops.plain() if switched else contextlib.nullcontext():
        assert oc.route(*facts) == want
    assert oc.route("cuda", False, True, False) == "kernel"


def test_route_is_the_denorm_kernels():
    """One rule for both eval-mode kernels: no size or type test of its
    own, so every eval call of the module on the card takes the kernel."""
    assert oc.route is denorm.route


def kernel_formula(cov, wk, img, w_img, mean, mul, shift):
    """csrc/objconv.cu's arithmetic on the CPU, from the inputs the
    wrapper is handed, in their type kdt: the image conv rounded to kdt and
    added in fp32, then kdt((kdt(v) - mean) * mul + shift) or
    kdt(v + shift), then the leaky ReLU."""
    kdt = cov.dtype
    B = cov.shape[0]
    H, W = cov.shape[-2:]
    v = object_basis_conv(cov.reshape(B, -1, H, W), wk)
    v = v + conv2d_nhwc(img, w_img, None, dtype=kdt).float()
    if mean is None:
        y = (v + shift).to(kdt)
    else:
        y = ((v.to(kdt).float() - mean) * mul + shift).to(kdt)
    return leaky_relu_02(y)


@pytest.mark.parametrize("norm", ["spectralsyncbatch", "spectralnone"])
@pytest.mark.parametrize("F", [32, 64])
def test_module_hands_the_kernel_what_it_takes(monkeypatch, norm, F):
    """On the kernel's route the module hands `objconv_fused` a bf16
    window in place (sliced from the clip), contiguous kernels and image,
    and a norm affine that gives the plain chain's result bit for bit."""
    _hand_the_kernel(monkeypatch, norm, F, BF16, 3)


@pytest.mark.parametrize("norm", ["spectralsyncbatch", "spectralnone"])
@pytest.mark.parametrize("F,dtype,img_ch", [(32, F32, 3), (512, F32, 3),
                                            (48, BF16, 3), (20, BF16, 6),
                                            (7, F32, 17)])
def test_module_hands_the_kernel_every_width_and_type(monkeypatch, norm, F,
                                                      dtype, img_ch):
    """fp32 compute and widths off the tensor cores' (F not a multiple of
    32, more than 16 image channels) take the kernel's route too: the
    module hands it the call, and the kernel's arithmetic gives the plain
    chain's result."""
    _hand_the_kernel(monkeypatch, norm, F, dtype, img_ch)


def _hand_the_kernel(monkeypatch, norm, F, dtype, img_ch):
    conv = make_conv(norm, F, dtype, img_ch=img_ch).eval()
    cov, vecs, img = make_window(2, 2, 3, 8, 16, 24, img_ch, dtype)
    taken = []

    def checked(cov_, wk, img_, w_img, mean, mul, shift):
        assert cov_.dtype == wk.dtype == img_.dtype == w_img.dtype == dtype
        assert cov_.data_ptr() == cov.data_ptr() and cov_[0].is_contiguous()
        assert wk.is_contiguous() and img_.is_contiguous()
        assert w_img.is_contiguous() and w_img.shape == (F, img_ch, 3, 3)
        assert (mean is None) == (norm == "spectralnone")
        taken.append(shift.shape)
        return kernel_formula(cov_, wk, img_, w_img, mean, mul, shift)

    with torch.no_grad():
        want = conv(cov, vecs, img)
        rule = _kernels.use_kernel  # the CPU stands in for the card
        monkeypatch.setattr(_kernels, "use_kernel", lambda dev, takes=True:
                            rule("cuda" if dev == "cpu" else dev, takes))
        monkeypatch.setattr(oc, "objconv_fused", checked)
        got = conv(cov, vecs, img)
    assert taken == [(F,)]
    assert_bit_equal(got, want)


def test_eval_affine_follows_the_buffers():
    bn = BatchNorm(8)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.normal_()
    first = bn.eval_affine()
    assert bn.eval_affine() is first
    assert torch.equal(first[1], torch.rsqrt(bn.running_var + bn.eps)
                       * bn.weight)
    with torch.no_grad():
        bn.weight.mul_(2.0)
    second = bn.eval_affine()
    assert second is not first
    assert torch.equal(second[1], torch.rsqrt(bn.running_var + bn.eps)
                       * bn.weight)
    bn(torch.randn(4, 3, 3, 8), train=True)  # moves both averages
    third = bn.eval_affine()
    assert third is not second and torch.equal(third[0], bn.running_mean)
    bn.bias = torch.nn.Parameter(torch.ones(8))  # a parameter replaced
    assert torch.equal(bn.eval_affine()[2], torch.ones(8))
    assert BatchNorm(8, use_bias=False).eval_affine()[2] is None


def _refuse_args(**over):
    B, nF, O, H, W, F, C = 2, 2, 3, 8, 8, 32, 3
    args = dict(cov=torch.zeros(B, nF, O, H, W, dtype=BF16),
                wk=torch.zeros(B, nF * O, 9, F, dtype=BF16),
                img=torch.zeros(B, H, W, C, dtype=BF16),
                w_img=torch.zeros(F, C, 3, 3, dtype=BF16),
                mean=torch.zeros(F), mul=torch.ones(F), shift=torch.zeros(F))
    args.update(over)
    return args


REFUSED = [
    (dict(cov=torch.zeros(2, 2, 3, 8, 8)), TypeError),
    (dict(wk=torch.zeros(2, 6, 9, 32)), TypeError),
    (dict(mean=torch.zeros(32, dtype=torch.float64)), TypeError),
    (dict(mul=None), ValueError),
    (dict(shift=None), ValueError),
    (dict(cov=torch.zeros(2, 8, 8, dtype=BF16)), ValueError),
    (dict(wk=torch.zeros(2, 5, 9, 32, dtype=BF16)), ValueError),
    (dict(wk=torch.zeros(2, 6, 4, 32, dtype=BF16)), ValueError),
    (dict(img=torch.zeros(2, 8, 7, 3, dtype=BF16)), ValueError),
    (dict(w_img=torch.zeros(32, 3, 3, 3, dtype=BF16)[:16]), ValueError),
    (dict(w_img=torch.zeros(32, 4, 3, 3, dtype=BF16)), ValueError),
    (dict(cov=torch.zeros(2, 2, 3, 8, 8, dtype=torch.float16),
          wk=torch.zeros(2, 6, 9, 32, dtype=torch.float16),
          img=torch.zeros(2, 8, 8, 3, dtype=torch.float16),
          w_img=torch.zeros(32, 3, 3, 3, dtype=torch.float16)), TypeError),
    (dict(w_img=torch.zeros(32, 3, 5, 5, dtype=BF16)), ValueError),
    (dict(shift=torch.zeros(16)), ValueError),
    (dict(cov=torch.zeros(2, 3, 2, 8, 8, dtype=BF16).transpose(1, 2)),
     ValueError),
    (dict(img=torch.zeros(2, 8, 8, 3, dtype=BF16).transpose(1, 2)),
     ValueError),
    ({}, ValueError),  # CPU tensors
]


@pytest.mark.parametrize("over,error", REFUSED)
def test_wrapper_refuses_what_the_kernel_does_not_take(over, error):
    with pytest.raises(error):
        oc.objconv_fused(**_refuse_args(**over))
