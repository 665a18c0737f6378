"""Card-only tests of the port's CUDA kernels (the rasterizer, the fused
SPADE denormalization and the fused factorized frontend conv), and of an
op whose CUDA backward the port works around (marker `gpu`).

Each kernel's tolerance against its plain version is defined once, in
torch_tools/kernel_checks.py; `ops.plain()` is the one way to force the
plain version. The tests skip without a CUDA card. This file imports neither jax
nor the JAX package, so it also runs where JAX is absent;
tests/conftest.py imports jax, so there run it as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import contextlib

import pytest
import torch

from ag2video_torch import ops
from ag2video_torch.ops import denorm as dn
from ag2video_torch.ops import rasterize as tr
from torch_tools.kernel_checks import (BF16_TOL, F32_TOL, hold_objconv,
                                       same_bits)


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
    (9, 12, 256, 256, 256, torch.bfloat16),   # disc: the action D's call
    (12, 12, 512, 256, 256, torch.bfloat16),  # msd: MultiscaleDiscriminator
]


@pytest.mark.gpu
@pytest.mark.parametrize("N,O,D,H,W,dtype", SHAPES)
def test_kernel_matches_plain(cuda, N, O, D, H, W, dtype):
    vecs, boxes, mask = _inputs(N, O, D, dtype, cuda)
    before = tr.KERNEL_LAUNCHES.n
    k = tr.boxes_to_layout_batch(vecs, boxes, H, W, mask=mask)
    torch.cuda.synchronize()
    assert tr.KERNEL_LAUNCHES.n == before + 1
    with ops.plain():
        p = tr.boxes_to_layout_batch(vecs, boxes, H, W, mask=mask)
    assert tr.KERNEL_LAUNCHES.n == before + 1
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
    with ops.plain():
        p = tr.boxes_to_layout_batch(vecs, boxes, 40, 40, mask=mask)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(k.float(), p.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("N,O,D,H,dtype", [
    (3, 6, 128, 32, torch.float32),
    # disc: the action D's call, bf16 vecs that carry a gradient and the
    # ground-truth boxes, which do not.
    (9, 12, 256, 256, torch.bfloat16),
])
def test_kernel_gradients_match_plain(cuda, N, O, D, H, dtype):
    vecs, boxes, mask = _inputs(N, O, D, dtype, cuda, seed=1)
    g = torch.randn(N, H, H, D, device=cuda, dtype=dtype)
    with_boxes = dtype == torch.float32
    grads = []
    for plain in (False, True):
        v = vecs.clone().requires_grad_(True)
        b = boxes.clone().requires_grad_(with_boxes)
        with ops.plain() if plain else contextlib.nullcontext():
            out = tr.boxes_to_layout_batch(v, b, H, mask=mask)
        grads.append(torch.autograd.grad((out.float() * g).sum(),
                                         (v, b) if with_boxes else (v,)))
    if not with_boxes:
        torch.testing.assert_close(grads[0][0].float(), grads[1][0].float(),
                                   **BF16_TOL)
        return
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


# The 18 SPADE norms of the cells' generator (ngf 64, 256x256, "normal"
# upsampling): (name, level H = W, channels, leaky ReLU fused).
SPADE_NORMS = []
for _blk, _h, _fin, _fout in (("head_0", 8, 1024, 1024),
                              ("G_middle_0", 16, 1024, 1024),
                              ("G_middle_1", 16, 1024, 1024),
                              ("up_0", 32, 1024, 512), ("up_1", 64, 512, 256),
                              ("up_2", 128, 256, 128), ("up_3", 256, 128, 64)):
    if _fin != _fout:
        SPADE_NORMS.append((f"{_blk}.norm_s", _h, _fin, False))
    SPADE_NORMS.append((f"{_blk}.norm_0", _h, _fin, True))
    SPADE_NORMS.append((f"{_blk}.norm_1", _h, min(_fin, _fout), True))


def _denorm_inputs(B, H, C, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(B, H, H, C, generator=g, device=device) * 3).to(dtype)
    gb = torch.randn(B, H, H, 2 * C, generator=g, device=device).to(dtype)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                            float("nan"), -1e-30, 1e30, -3.0],
                           device=device).to(dtype)
    x.view(-1)[:8] = special
    gb.view(-1)[:8] = special.flip(0)
    gb.view(-1)[C:C + 8] = special
    mean = torch.randn(C, generator=g, device=device)
    var = torch.rand(C, generator=g, device=device) * 2
    var[0] = 0.0
    return x, gb, mean, torch.rsqrt(var + 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("norm,H,C,act", SPADE_NORMS,
                         ids=[n[0] for n in SPADE_NORMS])
def test_denorm_kernel_is_bit_equal_to_plain(cuda, norm, H, C, act, B,
                                              dtype):
    x, gb, mean, mul = _denorm_inputs(B, H, C, dtype, cuda, H * C + B)
    for a in (act, not act):
        before = dn.KERNEL_LAUNCHES.n
        k = dn.denorm_fused(x, gb, mean, mul, a)
        torch.cuda.synchronize()
        assert dn.KERNEL_LAUNCHES.n == before + 1
        same_bits(k, dn.denorm_plain(x, gb, mean, mul, a))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_denorm_kernel_odd_channels_and_offsets(cuda, dtype):
    """C not a multiple of the vector width, and a misaligned view: the
    kernel's one-channel loop."""
    x, gb, mean, mul = _denorm_inputs(2, 5, 12, dtype, cuda, 7)
    for c in (3, 12):
        xs, gbs = x[..., :c].contiguous(), gb[..., :2 * c].contiguous()
        same_bits(dn.denorm_fused(xs, gbs, mean[:c].contiguous(),
                                  mul[:c].contiguous(), True),
                  dn.denorm_plain(xs, gbs, mean[:c], mul[:c], True))
    flat = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    xo = flat[1:].view(x.shape)
    xo.copy_(x)
    same_bits(dn.denorm_fused(xo, gb, mean, mul, False),
              dn.denorm_plain(x, gb, mean, mul, False))


@pytest.mark.gpu
def test_denorm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, gb, mean, mul = _denorm_inputs(2, 4, 16, torch.bfloat16, cuda, 3)
    with pytest.raises(TypeError):
        dn.denorm_fused(x.half(), gb.half(), mean, mul, True)
    with pytest.raises(ValueError):
        dn.denorm_fused(x.transpose(1, 2), gb, mean, mul, True)
    with pytest.raises(ValueError):
        dn.denorm_fused(x, gb[..., :24].contiguous(), mean, mul, True)
    with pytest.raises(ValueError):
        dn.denorm_fused(x.cpu(), gb, mean, mul, True)
    with pytest.raises(ValueError):
        dn.denorm_fused(x, gb, mean.cpu(), mul, True)


def _small_generator(cuda):
    from ag2video_torch.models.spade import SPADEGenerator
    from ag2video_torch.weights import init_params

    net = init_params(SPADEGenerator(12, ngf=8, dtype=torch.bfloat16), 0)
    g = torch.Generator().manual_seed(1)
    for m in net.modules():
        if hasattr(m, "running_var"):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=g) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=g) + 0.5)
    return net.to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [64, 32])
def test_spade_generator_with_the_kernel_is_bit_equal(cuda, monkeypatch,
                                                      size):
    """Every norm launches the kernel, at 32x32 (a 1x1 latent, upsampled
    into G_middle_0's input) as at 64x64."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    net = _small_generator(cuda)
    layout = torch.randn(2, size, size, 12, generator=torch.Generator()
                         .manual_seed(2)).to(cuda, torch.bfloat16)
    with torch.no_grad():
        before = dn.KERNEL_LAUNCHES.n
        fused = net(layout)
        launched = dn.KERNEL_LAUNCHES.n - before
        assert launched == 18
        monkeypatch.setattr(
            dn, "denorm_fused",
            lambda x, gb, mean, mul, act: dn.denorm_plain(x, gb, mean, mul,
                                                          act))
        plain = net(layout)
        # And today's ops: normalize_affine's sliced chain, then the ReLU.
        with ops.plain():
            eager = net(layout)
    torch.cuda.synchronize()
    same_bits(fused, plain)
    same_bits(fused, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_spade_denorm_on_the_card_is_todays_sequence(cuda, dtype):
    """SPADE.denorm through the kernel (its cached running statistics
    included) against the slice, `normalize_affine`, `leaky_relu_02`
    sequence it replaced."""
    from ag2video_torch.models.layers import leaky_relu_02
    from ag2video_torch.models.normalization import SPADE

    spade = SPADE("spadesyncbatch3x3", 256, 3).to(cuda)
    bn = spade.param_free_norm.bn
    x, gb, mean, _ = _denorm_inputs(2, 16, 256, dtype, cuda, 5)
    bn.running_mean.copy_(mean)
    bn.running_var.uniform_(0.0, 2.0)
    with torch.no_grad():
        for act in (True, False):
            before = dn.KERNEL_LAUNCHES.n
            got = spade.denorm(x, gb, False, act)
            assert dn.KERNEL_LAUNCHES.n == before + 1
            want = spade.normalize_affine(x, gb[..., :256], gb[..., 256:])
            same_bits(got, leaky_relu_02(want) if act else want)


# The fused factorized frontend conv (csrc/objconv.cu) against its plain
# chain, within torch_tools/kernel_checks.py's OBJCONV_* bounds.
# (B, nF, O, H, W, F, C): the B=16 cell's conv_dim_in and flow_down_0,
# ragged ones (a partial edge tile, widths that are and are not a multiple
# of 8, 64- and 32-feature blocks, K not a multiple of 8) and the largest
# sizes the kernel takes.
OBJCONV_SHAPES = [
    (16, 2, 11, 256, 256, 512, 3),
    (16, 2, 11, 256, 256, 32, 3),
    (1, 2, 3, 64, 64, 128, 3),
    (1, 2, 3, 50, 70, 128, 3),
    (1, 2, 11, 9, 200, 512, 3),
    (2, 2, 5, 37, 45, 64, 6),
    (2, 1, 1, 9, 33, 96, 1),
    (1, 4, 14, 40, 36, 1024, 16),
]
# (dtype, B, nF, O, H, W, F, C) off the tensor cores, on the kernel's CUDA
# cores: fp32 compute (the cell's width and ragged ones), and bf16 with F
# not a multiple of 32, more than 56 maps or more than 16 image channels.
OBJCONV_DIRECT = [
    (torch.float32, 2, 2, 11, 64, 64, 512, 3),
    (torch.float32, 1, 2, 3, 50, 70, 128, 3),
    (torch.float32, 2, 1, 1, 9, 33, 7, 1),
    (torch.bfloat16, 1, 2, 3, 50, 70, 48, 3),
    (torch.bfloat16, 2, 2, 5, 37, 45, 20, 6),
    (torch.bfloat16, 1, 3, 20, 33, 40, 96, 17),
]


def _objconv_inputs(B, nF, O, H, W, F, C, device, seed,
                    dtype=torch.bfloat16):
    """A window of box coverage sliced from a longer clip, projected
    kernels, an image, its kernel (all in `dtype`) and a BatchNorm with
    running statistics, all seeded."""
    from ag2video_torch.models.normalization import BatchNorm

    g = torch.Generator().manual_seed(seed)
    T = nF + 2
    boxes = torch.cat([torch.rand(B, T, O, 2, generator=g) * 0.8,
                       0.05 + torch.rand(B, T, O, 2, generator=g) * 0.5], -1)
    mask = (torch.rand(B, T, O, generator=g) > 0.2).float()
    cov = tr.box_coverage(boxes, H, W, mask).to(dtype)[:, 1:1 + nF]
    wk = (torch.randn(B, nF * O, 9, F, generator=g) * 0.3).to(dtype)
    img = torch.rand(B, H, W, C, generator=g).to(dtype)
    w_img = (torch.randn(F, C, 3, 3, generator=g) * 0.3).to(dtype)
    bn = BatchNorm(F, dtype=dtype)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(F, generator=g) * 0.3)
        bn.running_var.uniform_(0.3, 3.0, generator=g)
        bn.weight.copy_(1 + 0.3 * torch.randn(F, generator=g))
        bn.bias.copy_(0.3 * torch.randn(F, generator=g))
    bias = 0.3 * torch.randn(F, generator=g)
    to = lambda t: t.to(device)
    return (to(cov), to(wk), to(img), to(w_img), bn.to(device), to(bias))


def _objconv_against_plain(cuda, dtype, B, nF, O, H, W, F, C):
    """The kernel against `objconv_plain`, with the BatchNorm and with a
    bias alone, one launch each."""
    from ag2video_torch.ops import objconv as oc

    cov, wk, img, w_img, bn, bias = _objconv_inputs(
        B, nF, O, H, W, F, C, cuda, B * F + H + C, dtype)
    cov4 = cov.reshape(B, nF * O, H, W)
    mean, mul, shift = bn.eval_affine()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            for norm in (True, False):
                before = oc.KERNEL_LAUNCHES.n
                k = (oc.objconv_fused(cov, wk, img, w_img, mean, mul, shift)
                     if norm else
                     oc.objconv_fused(cov, wk, img, w_img, None, None, bias))
                torch.cuda.synchronize()
                assert oc.KERNEL_LAUNCHES.n == before + 1
                p = oc.objconv_plain(cov4, wk, img, w_img,
                                     bn if norm else None,
                                     None if norm else bias, False)
                hold_objconv(k, p, f"norm={norm}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.gpu
@pytest.mark.parametrize("B,nF,O,H,W,F,C", OBJCONV_SHAPES)
def test_objconv_kernel_matches_plain(cuda, B, nF, O, H, W, F, C):
    _objconv_against_plain(cuda, torch.bfloat16, B, nF, O, H, W, F, C)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,nF,O,H,W,F,C", OBJCONV_DIRECT)
def test_objconv_cuda_core_path_matches_plain(cuda, dtype, B, nF, O, H, W,
                                              F, C):
    _objconv_against_plain(cuda, dtype, B, nF, O, H, W, F, C)


@pytest.mark.gpu
def test_objconv_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from ag2video_torch.ops import objconv as oc

    cov, wk, img, w_img, bn, bias = _objconv_inputs(2, 2, 3, 16, 16, 64, 3,
                                                    cuda, 0)
    mean, mul, shift = bn.eval_affine()
    ok = dict(cov=cov, wk=wk, img=img, w_img=w_img, mean=mean, mul=mul,
              shift=shift)
    bad = [
        dict(wk=wk[:, :5].contiguous()),             # wk's maps
        dict(wk=wk[..., :4, :].contiguous()),         # wk's shifts
        dict(mean=mean[:48].contiguous()),            # the norm's features
        dict(w_img=torch.zeros(64, 3, 5, 5, dtype=w_img.dtype,
                               device=cuda)),         # a 5x5 kernel
        dict(w_img=w_img[:32].contiguous()),          # img part's features
        dict(w_img=w_img[:, :2].contiguous()),        # img part's channels
        dict(wk=wk.transpose(1, 2).contiguous().transpose(1, 2)),
        dict(img=img.cpu()),
        dict(mean=mean.cpu()),
    ]
    for over in bad:
        with pytest.raises(ValueError):
            oc.objconv_fused(**dict(ok, **over))
    with pytest.raises(TypeError):
        oc.objconv_fused(**dict(ok, wk=wk.float()))


def _small_factorized_cfg(**over):
    from ag2video_torch import Config, get_vocab

    vocab = get_vocab("cater")
    kw = dict(dataset="cater", image_size=(64, 64), embedding_dim=16,
              gconv_dim=16, gconv_hidden_dim=32, ngf=8, nff=32,
              n_blocks_F=1, n_downsample_F=2)
    kw.update(over)
    return Config(**kw).derive(vocab), vocab


@pytest.mark.gpu
@pytest.mark.parametrize("factorized", [True, False])
def test_generate_launches_each_kernel_per_call(cuda, factorized):
    """A T=8 `generate` call launches the denorm kernel for every norm of
    every generated frame (18 x 7 = 126); the objconv kernel twice a frame
    on the factorized frontend (flow_down_0 and conv_dim_in: 14) and never
    on the dense one; the rasterizer once on the dense frontend (all T
    layouts) and never on the factorized one; and the plain rasterizer
    never. Inside `ops.plain()` none of the three kernels launches."""
    from ag2video_torch.inference import generate, make_inputs
    from ag2video_torch.models import AG2VideoModel
    from ag2video_torch.ops import objconv as oc

    cfg, vocab = _small_factorized_cfg(factorized_frontend=factorized)
    assert cfg.compute_dtype == "bfloat16"
    model = AG2VideoModel(cfg, vocab)
    T = 8
    batch = make_inputs(cfg, vocab, 2, T, seed=0)
    generate(model, batch)  # builds the kernels
    counts = (tr.KERNEL_LAUNCHES, tr.PLAIN_CALLS, dn.KERNEL_LAUNCHES,
              oc.KERNEL_LAUNCHES)

    def launches():
        for c in counts:
            c.reset()
        imgs, _ = generate(model, batch)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(imgs).all())
        return tuple(c.n for c in counts)

    frames = T - cfg.n_frames_G + 1
    assert (18 * frames, 2 * frames) == (126, 14)
    # (rasterizer, plain rasterizer calls, denorm, objconv)
    assert launches() == ((0, 0, 126, 14) if factorized else (1, 0, 126, 0))
    with ops.plain():
        assert launches() == (0, 0 if factorized else 1, 0, 0)


@pytest.mark.gpu
def test_fp32_generate_launches_objconv_and_matches_the_eager_ops(
        cuda, monkeypatch):
    """In fp32 compute too, every generated frame launches the kernel
    twice (its CUDA-core path), and the frames match those of the eager
    ops (inside `ops.plain()`, TF32 off) to fp32 rounding."""
    from ag2video_torch.inference import generate, make_inputs
    from ag2video_torch.models import AG2VideoModel
    from ag2video_torch.ops import objconv as oc

    # semantic_nc 4 attributes x 12 = 48 and nff 24: no multiple of 32.
    cfg, vocab = _small_factorized_cfg(compute_dtype="float32",
                                       embedding_dim=12, nff=24)
    assert (cfg.semantic_nc, cfg.nff) == (48, 24)
    model = AG2VideoModel(cfg, vocab)
    T = 8
    batch = make_inputs(cfg, vocab, 2, T, seed=0)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    generate(model, batch)  # builds the kernels
    before = oc.KERNEL_LAUNCHES.n
    imgs, _ = generate(model, batch)
    torch.cuda.synchronize()
    assert oc.KERNEL_LAUNCHES.n - before == 2 * (T - cfg.n_frames_G + 1)
    with ops.plain():
        want, _ = generate(model, batch)
    assert oc.KERNEL_LAUNCHES.n - before == 2 * (T - cfg.n_frames_G + 1)
    rel = float((imgs - want).norm() / want.norm())
    assert rel <= 1e-4, rel


@pytest.mark.gpu
def test_train_step_launches_no_objconv(cuda):
    from ag2video_torch.inference import make_inputs
    from ag2video_torch.ops import objconv as oc
    from ag2video_torch.train import Trainer

    cfg, vocab = _small_factorized_cfg(frames_per_action=3, max_objects=5,
                                       max_triplets=6, max_actions=2,
                                       gconv_num_layers=2, batch_size=2,
                                       frames_per_action_graph=1, num_D=2,
                                       n_layers_D=2)
    batch = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    trainer = Trainer(cfg, vocab)
    trainer.init(batch)
    before = oc.KERNEL_LAUNCHES.n
    trainer.train_step(batch)
    torch.cuda.synchronize()
    assert oc.KERNEL_LAUNCHES.n == before


@pytest.mark.gpu
@pytest.mark.parametrize("factorized", [True, False])
def test_generate_never_waits_on_the_card(cuda, factorized):
    """After a warm-up call, a `generate` call makes no CUDA call that
    waits for the card (sync debug mode 'error'), builds no device
    constant, and gives the outputs of the former route bit for bit: the
    model called on the whole `imgs`, every input uploaded from pageable
    memory."""
    from ag2video_torch.inference import generate, make_inputs
    from ag2video_torch.inference.generate import _DTYPES
    from ag2video_torch.models import AG2VideoModel
    from ag2video_torch.ops import constants

    cfg, vocab = _small_factorized_cfg(factorized_frontend=factorized)
    model = AG2VideoModel(cfg, vocab)
    batch = make_inputs(cfg, vocab, 2, 8, seed=0)
    generate(model, batch)  # builds the kernels and the constants
    torch.cuda.synchronize()
    before = constants.BUILDS.n
    torch.cuda.set_sync_debug_mode("error")
    try:
        imgs, boxes = generate(model, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert constants.BUILDS.n == before
    t = {k: torch.as_tensor(batch[k]).to(cuda, d) for k, d in _DTYPES.items()}
    with torch.no_grad():
        out = model(t["imgs"], t["objs"], t["triplets"], t["actions"],
                    t["boxes"], test_mode=True)
    assert torch.equal(imgs, out["imgs_pred"])
    assert torch.equal(boxes, out["boxes_pred"])
