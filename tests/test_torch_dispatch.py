"""What a `generate` call sends to the device, on the CPU (port only, fp32,
32x32).

The test path reads only the conditioning frames, so `generate` uploads
only those: frames past them may be NaN without moving a bit of the
output, while the teacher-forced forward still needs every frame. The
cached device constants (ops/constants.py) equal the expressions that
built them on every call before, bit for bit, and a second call builds
none.
"""

import numpy as np
import pytest
import torch

from ag2video_torch.config import Config
from ag2video_torch.inference import generate, make_inputs
from ag2video_torch.models import AG2VideoModel
from ag2video_torch.ops import constants, rasterize, sampling, warp
from ag2video_torch.vocab import synthetic_vocab

torch.set_num_threads(2)

TINY = dict(dataset="synthetic", image_size=(32, 32), frames_per_action=4,
            embedding_dim=16, gconv_dim=16, gconv_hidden_dim=32,
            gconv_num_layers=2, ngf=4, nff=4, n_blocks_F=1,
            n_downsample_F=2, max_objects=5, max_triplets=6, max_actions=2,
            compute_dtype="float32")
T = 4
SIZES = [1, 2, 7, 64, 256]


@pytest.fixture(scope="module", params=[True, False],
                ids=["factorized", "dense"])
def gen(request):
    vocab = synthetic_vocab()
    cfg = Config(**dict(TINY, factorized_frontend=request.param)
                 ).derive(vocab)
    model = AG2VideoModel(cfg, vocab, device="cpu")
    return model, make_inputs(cfg, vocab, 2, T, seed=0)


def bits(t):
    return t.contiguous().view(torch.int32)


def test_generate_reads_only_the_conditioning_frames(gen):
    model, batch = gen
    ncond = model.config.n_frames_G - 1
    nan = dict(batch, imgs=batch["imgs"].copy())
    nan["imgs"][:, ncond:] = np.nan
    seen = []
    hook = model.layout_to_video.register_forward_pre_hook(
        lambda _, args: seen.append(tuple(args[0].shape)))
    try:
        imgs, boxes = generate(model, batch)
        imgs_nan, boxes_nan = generate(model, nan)
    finally:
        hook.remove()
    assert seen == [(2, ncond, 32, 32, 3)] * 2
    assert tuple(imgs.shape) == (2, T, 32, 32, 3)
    assert bool(torch.isfinite(imgs).all())
    assert torch.equal(bits(imgs_nan), bits(imgs))
    assert torch.equal(bits(boxes_nan), bits(boxes))


def test_teacher_forced_forward_needs_every_frame(gen):
    """With only the conditioning frames the teacher-forced forward raises,
    and it reads the later ones (a NaN there reaches the output); the
    autoregressive one raises without the conditioning frames."""
    model, batch = gen
    ncond = model.config.n_frames_G - 1
    args = [torch.as_tensor(batch[k]) for k in
            ("imgs", "objs", "triplets", "actions", "boxes")]
    args[0] = args[0].clone()
    args[0][:, ncond:] = float("nan")
    with torch.no_grad():
        with pytest.raises(ValueError, match="teacher forcing"):
            model(args[0][:, :ncond], *args[1:], test_mode=False)
        out = model(*args, test_mode=False)
        with pytest.raises(ValueError, match="conditioning"):
            model(args[0][:, :ncond - 1], *args[1:], test_mode=True)
    assert not bool(torch.isfinite(out["imgs_pred"][:, ncond:]).all())


def former_flow_grid(flow):
    H, W = flow.shape[-3], flow.shape[-2]
    dev = flow.device
    xs = torch.linspace(-1.0, 1.0, W, dtype=torch.float32, device=dev)
    ys = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=dev)
    base = torch.stack([xs[None, :].expand(H, W), ys[:, None].expand(H, W)],
                       dim=-1)
    scale = torch.tensor([(W - 1.0) / 2.0, (H - 1.0) / 2.0],
                         dtype=torch.float32, device=dev)
    return base + flow.float() / scale


def former_centers(S, device):
    return (torch.arange(S, dtype=torch.float32, device=device)
            / torch.tensor(float(max(S - 1, 1)), device=device))


def former_linspace01(n, device=None):
    if n == 1:
        return torch.zeros(1, device=device)
    r = torch.tensor(1.0, device=device) / torch.tensor(float(n - 1),
                                                         device=device)
    out = torch.arange(n, dtype=torch.float32, device=device) * r
    out[-1] = 1.0
    return out


@pytest.mark.parametrize("S", SIZES)
def test_cached_constants_are_the_former_expressions(S, monkeypatch):
    monkeypatch.setattr(constants, "_CACHE", {})
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(S)
    flows = [torch.randn(2, S, S, 2, generator=g) * 9.0,
             torch.randn(1, S, 3, 2, generator=g) * 9.0]

    def calls():
        return ([warp.flow_grid(f) for f in flows]
                + [rasterize._centers(S, cpu), sampling.linspace01(S, cpu)])

    want = ([former_flow_grid(f) for f in flows]
            + [former_centers(S, cpu), former_linspace01(S, cpu)])
    before = constants.BUILDS.n
    first = calls()
    # Two warp grids (base and scale) per shape, the centres, the linspace.
    assert constants.BUILDS.n - before == 2 * 2 + 2
    again = calls()
    assert constants.BUILDS.n - before == 6
    for a, b, w in zip(first, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(bits(a), bits(w))
        assert torch.equal(bits(b), bits(w))


def test_a_cached_constant_is_a_normal_tensor_under_inference_mode(
        monkeypatch):
    """Built inside inference_mode, the warp's scale may still be saved
    for a backward taken outside it."""
    monkeypatch.setattr(constants, "_CACHE", {})
    flow = torch.randn(1, 8, 8, 2)
    with torch.inference_mode():
        warp.flow_grid(flow)
    flow.requires_grad_(True)
    warp.flow_grid(flow).sum().backward()
    want = torch.ones(1, 8, 8, 2) / torch.tensor([3.5, 3.5])
    assert torch.equal(bits(flow.grad), bits(want))
