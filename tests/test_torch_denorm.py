"""The SPADE norm's eval chain (ops/denorm.py, SPADE.denorm) on the CPU.

The fused CUDA kernel runs only on the card (tests/test_torch_gpu.py). Here:
the plain chain is the eager sequence it replaces, bit for bit; the new
dispatch gives today's results on the CPU, in eval and in train mode; the
route is chosen by device, mode, norm kind, grad mode and the
`ops.plain()` switch; every norm of the generator hands the kernel inputs
it takes; the cached running statistics follow the buffers; and the
wrapper refuses what the kernel does not take before it looks for a card.
"""

import contextlib
import copy

import pytest
import torch

from ag2video_torch.models.layers import leaky_relu_02
from ag2video_torch.models.normalization import SPADE
from ag2video_torch.models.spade import SPADEResnetBlock
from ag2video_torch import ops
from ag2video_torch.ops import _kernels
from ag2video_torch.ops import denorm as dn
from ag2video_torch.weights import init_params


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so that NaNs compare too."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def assert_bit_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(bits(a), bits(b))


def make_spade(kind: str, C: int, seed: int = 0) -> SPADE:
    g = torch.Generator().manual_seed(seed)
    spade = init_params(SPADE(f"spade{kind}3x3", C, 3), seed)
    bn = spade.param_free_norm.bn
    if hasattr(bn, "running_mean"):
        with torch.no_grad():
            bn.running_mean.copy_(torch.randn(C, generator=g))
            bn.running_var.copy_(torch.rand(C, generator=g) * 2)
            bn.running_var[0] = 0.0
    return spade


def make_inputs(C: int, dtype: torch.dtype, seed: int = 1, special=True):
    """x (2, 5, 6, C) and gb (2, 5, 6, 2C) with zeros, infinities and NaNs
    among normal draws."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(2, 5, 6, C, generator=g) * 3).to(dtype)
    gb = torch.randn(2, 5, 6, 2 * C, generator=g).to(dtype)
    if special:
        flat = x.view(-1)
        flat[:6] = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                                 float("nan"), -1e-30]).to(dtype)
        gbf = gb.view(-1)
        gbf[3:5] = torch.tensor([float("inf"), float("nan")]).to(dtype)
        gbf[C + 7] = -1.0  # gamma = -1: 1 + gamma = 0
    return x, gb


def todays_sequence(spade: SPADE, x, gb, train: bool, act: bool):
    """The ops SPADEResnetBlock ran before the dispatch: slice gamma and
    beta, `normalize_affine`, then `leaky_relu_02`."""
    C = x.shape[-1]
    y = spade.normalize_affine(x, gb[..., :C], gb[..., C:], train)
    return leaky_relu_02(y) if act else y


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["syncbatch", "batch"])
def test_plain_chain_is_the_eager_sequence(kind, dtype, act):
    spade = make_spade(kind, 16)
    x, gb = make_inputs(16, dtype)
    mean, mul = spade.param_free_norm.running_stats()
    assert_bit_equal(dn.denorm_plain(x, gb, mean, mul, act),
                     todays_sequence(spade, x, gb, False, act))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["syncbatch", "batch", "instance", "group"])
def test_dispatch_on_cpu_is_todays_sequence(kind, dtype, act, train):
    spade = make_spade(kind, 64)
    before = copy.deepcopy(spade)
    x, gb = make_inputs(64, dtype, special=not train)
    assert_bit_equal(spade.denorm(x, gb, train, act),
                     todays_sequence(before, x, gb, train, act))
    for (k, a), b in zip(spade.state_dict().items(),
                         before.state_dict().values()):
        assert torch.equal(a, b), k  # train mode moved both alike


def test_dispatch_takes_a_stride0_view_on_cpu():
    """A stride-0 view of a 1x1 map: the CPU dispatch gives today's result
    for it (on the card the kernel would refuse it)."""
    spade = make_spade("syncbatch", 8)
    x = torch.randn(2, 1, 1, 8).expand(2, 2, 2, 8)
    assert not x.is_contiguous()
    _, gb = make_inputs(8, torch.float32, special=False)
    gb = gb[:, :2, :2].contiguous()
    assert_bit_equal(spade.denorm(x, gb, False, True),
                     todays_sequence(spade, x, gb, False, True))


@pytest.mark.parametrize("hw", [1, 3])
def test_upsample_nearest_is_contiguous(hw):
    """A 1x1 map upsampled (a 32x32 frame's latent) is a copy, not a
    stride-0 view, so the norm after it takes the kernel on the card."""
    from ag2video_torch.models.layers import upsample_nearest

    x = torch.randn(2, hw, hw, 8)
    y = upsample_nearest(x)
    assert y.is_contiguous() and y.shape == (2, 2 * hw, 2 * hw, 8)
    assert torch.equal(y, x.repeat_interleave(2, 1).repeat_interleave(2, 2))


@pytest.mark.parametrize("size", [32, 64])
def test_every_generator_norm_is_one_the_kernel_takes(monkeypatch, size):
    """Each of an eval SPADEGenerator's 18 norms, with the CPU standing in
    for the kernels' device, hands `denorm_fused` inputs it takes
    (contiguous, one type, 2C channels), at 32x32 (a 1x1 latent) as at
    64x64; the result is the eager one."""
    from ag2video_torch.models.spade import SPADEGenerator

    net = init_params(SPADEGenerator(12, ngf=8, dtype=BF16), 0).eval()
    layout = torch.randn(2, size, size, 12).to(BF16)
    with torch.no_grad():
        want = net(layout)
        taken = []

        def checked(x, gb, mean, mul, act):
            assert x.is_contiguous() and gb.is_contiguous()
            assert x.dtype == gb.dtype in dn.KERNEL_DTYPES
            assert gb.shape == x.shape[:-1] + (2 * x.shape[-1],)
            assert mean.is_contiguous() and mul.is_contiguous()
            taken.append(tuple(x.shape))
            return dn.denorm_plain(x, gb, mean, mul, act)

        rule = _kernels.use_kernel  # the CPU stands in for the card
        monkeypatch.setattr(_kernels, "use_kernel", lambda dev, takes=True:
                            rule("cuda" if dev == "cpu" else dev, takes))
        monkeypatch.setattr(dn, "denorm_fused", checked)
        got = net(layout)
    assert len(taken) == 18
    assert_bit_equal(got, want)


def test_dispatch_keeps_gradients_on_cpu():
    spade = make_spade("syncbatch", 8)
    x, gb = make_inputs(8, torch.float32, special=False)
    x.requires_grad_(True)
    gb.requires_grad_(True)
    gx, ggb = torch.autograd.grad(spade.denorm(x, gb, False, True).sum(),
                                  (x, gb))
    x2, gb2 = x.detach().requires_grad_(True), gb.detach().requires_grad_(True)
    want = torch.autograd.grad(
        todays_sequence(spade, x2, gb2, False, True).sum(), (x2, gb2))
    assert torch.equal(gx, want[0]) and torch.equal(ggb, want[1])


BF16, F32 = torch.bfloat16, torch.float32
# (device, train, running stats, needs grad, inside ops.plain()) -> route
ROUTES = [
    (("cuda", False, True, False, False), "kernel"),
    (("cpu", False, True, False, False), "plain"),
    (("meta", False, True, False, False), "plain"),
    (("cuda", True, True, False, False), "plain"),
    (("cuda", False, False, False, False), "plain"),
    (("cuda", False, True, True, False), "plain"),
    (("cuda", True, False, False, False), "plain"),
    (("cuda", True, True, True, False), "plain"),
    (("cpu", True, True, False, False), "plain"),
    (("cpu", False, False, False, False), "plain"),
    (("cpu", False, True, True, False), "plain"),
    (("cuda", False, True, False, True), "plain"),
]


@pytest.mark.parametrize("facts,want", ROUTES)
def test_route(facts, want):
    *facts, switched = facts
    with ops.plain() if switched else contextlib.nullcontext():
        assert dn.route(*facts) == want
    assert dn.route("cuda", False, True, False) == "kernel"


@pytest.mark.parametrize("kind,running", [("syncbatch", True),
                                          ("sync_batch", True),
                                          ("batch", True),
                                          ("instance", False),
                                          ("group", False)])
def test_param_free_kind_tells_running_statistics(kind, running):
    assert SPADE(f"spade{kind}3x3", 8, 3).param_free_norm.running is running


def test_running_stats_follow_the_buffers():
    spade = make_spade("syncbatch", 8)
    pfn = spade.param_free_norm
    bn = pfn.bn
    first = pfn.running_stats()
    assert all(a is b for a, b in zip(pfn.running_stats(), first))
    assert torch.equal(first[0], bn.running_mean)
    assert torch.equal(first[1], torch.rsqrt(bn.running_var + bn.eps))

    with torch.no_grad():
        bn.running_var.mul_(3.0)
    second = pfn.running_stats()
    assert second[1] is not first[1]
    assert torch.equal(second[1], torch.rsqrt(bn.running_var + bn.eps))

    pfn(torch.randn(4, 3, 3, 8), train=True)  # moves both averages
    third = pfn.running_stats()
    assert third[1] is not second[1]
    assert torch.equal(third[0], bn.running_mean)
    assert torch.equal(third[1], torch.rsqrt(bn.running_var + bn.eps))

    bn.running_var = torch.full((8,), 0.5)  # a buffer replaced
    fourth = pfn.running_stats()
    assert fourth[1] is not third[1]
    assert torch.equal(fourth[1], torch.rsqrt(bn.running_var + bn.eps))

    with torch.inference_mode():
        with torch.no_grad():
            bn.running_mean.add_(1.0)
        fifth = pfn.running_stats()
    assert not fifth[1].is_inference()
    assert torch.equal(fifth[0], bn.running_mean)


def _refused(x, gb, mean, mul):
    return dn.denorm_fused(x, gb, mean, mul, True)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, gb = make_inputs(8, BF16, special=False)
    mean, mul = torch.zeros(8), torch.ones(8)
    with pytest.raises(TypeError):
        _refused(x.half(), gb.half(), mean, mul)
    with pytest.raises(TypeError):
        _refused(x, gb.float(), mean, mul)
    with pytest.raises(TypeError):
        _refused(x, gb, mean.double(), mul)
    with pytest.raises(ValueError):
        _refused(x, gb[..., :12].contiguous(), mean, mul)
    with pytest.raises(ValueError):
        _refused(x, gb, mean[:4], mul)
    with pytest.raises(ValueError):
        _refused(x.transpose(1, 2), gb.transpose(1, 2), mean, mul)
    with pytest.raises(ValueError):
        _refused(x, gb, mean, mul)  # CPU tensors


class _OldBlock(torch.nn.Module):
    """SPADEResnetBlock.forward as it was before the dispatch."""

    def __init__(self, block: SPADEResnetBlock, fin: int, fmiddle: int):
        super().__init__()
        self.b, self.ncs = block, [fin, fmiddle, fin]

    def forward(self, x, seg, train):
        from ag2video_torch.models.layers import conv2d_nhwc, resize_nearest
        b = self.b
        norms = [b.norm_0, b.norm_1] + ([b.norm_s] if b.shortcut else [])
        seg_r = resize_nearest(seg, tuple(x.shape[-3:-1]))
        actv = torch.relu(conv2d_nhwc(
            seg_r, torch.cat([n.mlp_shared.weight for n in norms], 0),
            torch.cat([n.mlp_shared.bias for n in norms], 0),
            dtype=b.dtype))
        nh = b.norm_0.nhidden
        gammas, betas = [], []
        for i, (n, nc) in enumerate(zip(norms, self.ncs)):
            gb = conv2d_nhwc(actv[..., i * nh:(i + 1) * nh],
                             *n.gamma_beta_kernels(), dtype=b.dtype)
            gammas.append(gb[..., :nc])
            betas.append(gb[..., nc:])
        x_s = x
        if b.shortcut:
            x_s = b.conv_s(b.norm_s.normalize_affine(
                x, gammas[2], betas[2], train), train)
        dx = b.norm_0.normalize_affine(x, gammas[0], betas[0], train)
        dx = b.conv_0(leaky_relu_02(dx), train)
        dx = b.norm_1.normalize_affine(dx, gammas[1], betas[1], train)
        dx = b.conv_1(leaky_relu_02(dx), train)
        return x_s + dx


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resblock_matches_its_former_forward(dtype, train):
    block = init_params(SPADEResnetBlock(16, 8, 5, dtype=dtype), 0)
    for m in block.modules():
        if hasattr(m, "running_var"):
            with torch.no_grad():
                m.running_mean.normal_()
                m.running_var.uniform_(0.5, 2.0)
    old = _OldBlock(copy.deepcopy(block), 16, 8)
    x = torch.randn(2, 6, 6, 16).to(dtype)
    seg = torch.randn(2, 12, 12, 5).to(dtype)
    assert_bit_equal(block(x, seg, train), old(x, seg, train))
    for (k, a), b in zip(block.state_dict().items(),
                         old.b.state_dict().values()):
        assert torch.equal(a, b), k
