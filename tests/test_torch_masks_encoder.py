"""The port's mask path and VAE encoder against the JAX package, fp32 on
the CPU.

`MaskNet` (eval mode, and train mode with its BatchNorm statistics and
gradients), `create_mask_vecs`, `ops.rasterize.boxes_to_mask` and
`masks_to_layout` in train and test mode, and `ConvEncoder` on an input
that is upsampled (64x64) and one that is downsampled (320x320) to its
256x256 (eval mode on both, train mode on the second), with
`reparameterize`. Weights as in
tests/test_torch_variants.py (the port's seeded init carried into the JAX
tree, perturbed, loaded back strictly).

Bounds: `boxes_to_mask` and the test mode's compositing order are exact
(an equal-mass pair of different objects, in both index orders, comes out
as JAX's stable argsort orders it); values rtol = atol = 1e-5 (fp32,
summation order only; test_torch_variants.py's gradient and state
bounds).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.models.encoder import ConvEncoder as JConvEncoder
from ag2video_tpu.models.layout_model import MaskNet as JMaskNet
from ag2video_tpu.models.layout_model import \
    create_mask_vecs as j_create_mask_vecs
from ag2video_tpu.ops.rasterize import boxes_to_mask, masks_to_layout
from ag2video_torch.models import ConvEncoder
from ag2video_torch.models.encoder import reparameterize
from ag2video_torch.models.layout_model import MaskNet, create_mask_vecs
from ag2video_torch.ops import boxes_to_mask as t_boxes_to_mask
from ag2video_torch.ops import masks_to_layout as t_masks_to_layout
from ag2video_torch.weights import from_flax
from tests.test_torch_variants import (FEAT_TOL, assert_outputs, carry,
                                       check_module, j_eval)

torch.set_num_threads(2)

# One compile per shape costs less than JAX's op-by-op compiles.
j_masks_to_layout = jax.jit(masks_to_layout,
                            static_argnames=("H", "W", "test_mode"))
j_boxes_to_mask = jax.jit(boxes_to_mask, static_argnums=(1, 2))


def test_masknet_matches_eval_and_train():
    rng = np.random.RandomState(0)
    vecs = rng.randn(2, 3, 6).astype(np.float32)
    jm = JMaskNet(mask_size=8)
    variables, tm = carry(jm, lambda: MaskNet(6, 8), (jnp.asarray(vecs),), 1,
                          train=True)
    n, got, _ = check_module(jm, variables, (jnp.asarray(vecs),), tm,
                             (torch.from_numpy(vecs),), (0,))
    assert got.shape == (2, 3, 8, 8)
    assert n == 2 * 3  # three stages' BatchNorm statistics


def test_masknet_sizes():
    assert MaskNet(4, 1)(torch.zeros(2, 4)).shape == (2, 1, 1)
    assert MaskNet(4, 2).n_stages == 1 and MaskNet(4, 16).n_stages == 4
    with pytest.raises(ValueError, match="power of 2"):
        MaskNet(4, 12)
    with pytest.raises(ValueError, match="power of 2"):
        JMaskNet(mask_size=12).init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))


def test_create_mask_vecs_shares_one_noise_vector():
    obj = np.random.RandomState(2).randn(2, 3, 5).astype(np.float32)
    want = np.asarray(jax.jit(j_create_mask_vecs, static_argnums=2)(
        jnp.asarray(obj), jax.random.PRNGKey(0), 4))
    got = create_mask_vecs(torch.from_numpy(obj),
                           torch.Generator().manual_seed(0), 4)
    again = create_mask_vecs(torch.from_numpy(obj),
                             torch.Generator().manual_seed(0), 4)
    for out in (want, got.numpy()):
        assert out.shape == (2, 3, 9)
        np.testing.assert_array_equal(out[..., :5], obj)
        noise = out[..., 5:].reshape(-1, 4)
        assert (noise == noise[0]).all() and np.abs(noise[0]).sum() > 0
    assert torch.equal(got, again)


def test_boxes_to_mask_matches_exactly():
    rng = np.random.RandomState(3)
    boxes = np.concatenate([rng.uniform(-0.2, 0.9, (2, 3, 6, 2)),
                            rng.uniform(0.0, 0.6, (2, 3, 6, 2))],
                           -1).astype(np.float32)
    boxes[0, 0, 1] = 0.0
    boxes[1, 2, 4] = [0.25, 0.5, 0.25, 0.25]  # edges on the pixel grid
    mask = rng.rand(2, 3, 6) > 0.3
    for m in (None, mask):
        want = np.asarray(j_boxes_to_mask(
            jnp.asarray(boxes), 16, 20, None if m is None else jnp.asarray(m)))
        got = t_boxes_to_mask(torch.from_numpy(boxes), 16, 20,
                              None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32 and got.shape == (2, 3, 16, 20)
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.mean() < 1


def _layout_args(rng, O=5, D=4, M=8):
    boxes = np.concatenate([rng.uniform(0.0, 0.6, (O, 2)),
                            rng.uniform(0.2, 0.5, (O, 2))],
                           -1).astype(np.float32)
    masks = rng.rand(O, M, M).astype(np.float32)
    vecs = rng.randn(O, D).astype(np.float32)
    # Two identical objects (equal mass), a zero-width box, a masked one.
    boxes[3], masks[3], vecs[3] = boxes[1], masks[1], vecs[1]
    boxes[2, 2] = 0.0
    obj_mask = np.array([1, 1, 1, 1, 0], np.float32)
    return vecs, boxes, masks, obj_mask


# (H, W, with obj_mask): two sizes with the mask, then none, where the
# all-zero-box test decides and W defaults to H.
LAYOUT_CALLS = ((16, 16, True), (12, 20, True), (10, None, False))


@pytest.mark.parametrize("test_mode", [False, True])
def test_masks_to_layout_matches(test_mode):
    args = _layout_args(np.random.RandomState(4))

    def j_all(vecs, boxes, masks, obj_mask):  # one compile for the three
        return [masks_to_layout(vecs, boxes, masks, H, W, obj_mask=(
            obj_mask if with_mask else None), test_mode=test_mode)
            for H, W, with_mask in LAYOUT_CALLS]

    wants = jax.jit(j_all)(*(jnp.asarray(a) for a in args))
    for (H, W, with_mask), want in zip(LAYOUT_CALLS, wants):
        got = t_masks_to_layout(*(torch.from_numpy(a) for a in args[:3]),
                                H, W, obj_mask=(torch.from_numpy(args[3])
                                                if with_mask else None),
                                test_mode=test_mode)
        assert got.shape == want.shape == (H, W or H, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)


@pytest.mark.parametrize("swap", [False, True])
def test_masks_to_layout_equal_mass_order_is_stable(swap):
    """Two different objects of exactly equal mass (2.75, dyadic: the 2x2
    grid samples the 2x2 masks exactly) over the same pixels: the one with
    the lower index composites first and keeps the pixels they share."""
    a = [[1.0, 1.0], [0.75, 0.0]]
    b = [[0.0, 0.75], [1.0, 1.0]]
    masks = np.array([b, a] if swap else [a, b], np.float32)
    vecs = np.ones((2, 1), np.float32)
    boxes = np.array([[0, 0, 1, 1]] * 2, np.float32)
    want = np.asarray(j_masks_to_layout(
        jnp.asarray(vecs), jnp.asarray(boxes), jnp.asarray(masks), H=2,
        test_mode=True))[..., 0]
    got = t_masks_to_layout(torch.from_numpy(vecs), torch.from_numpy(boxes),
                            torch.from_numpy(masks), 2,
                            test_mode=True)[..., 0]
    first = masks[0]
    expect = np.where(first > 0.5, first, masks[1])
    np.testing.assert_array_equal(want, expect)
    np.testing.assert_array_equal(got.numpy(), expect)


@functools.lru_cache(maxsize=None)
def _encoder_variables():
    """The carried weights, built once for both input sizes: the encoder
    resizes every input to 256x256 first, so a 256x256 template (no resize
    to trace) has the same leaves."""
    return carry(JConvEncoder(nf=4, z_dim=8),
                 lambda: ConvEncoder(nf=4, z_dim=8),
                 (jnp.zeros((2, 256, 256, 3)),), 6)[0]


@pytest.mark.parametrize("size", [64, 320])
def test_conv_encoder_matches(size):
    """Eval mode on an upsampled and a downsampled input; train mode (the
    state and the gradients) on the downsampled one, whose antialiased
    resize is the one that differs from plain bilinear."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    jm = JConvEncoder(nf=4, z_dim=8)
    variables = _encoder_variables()
    tm = from_flax(variables, ConvEncoder(nf=4, z_dim=8))
    if size > 256:
        n, got, _ = check_module(jm, variables, (jnp.asarray(x),), tm,
                                 (torch.from_numpy(x),), (0,))
        assert n == 2 * 6  # six spectral norms' u and sigma
    else:
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
        assert_outputs(got, j_eval(jm, variables, jnp.asarray(x)))
    assert [tuple(g.shape) for g in got] == [(2, 8), (2, 8)]


def test_reparameterize():
    mu = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    logvar = torch.randn(3, 5, generator=torch.Generator().manual_seed(2))
    z = reparameterize(torch.Generator().manual_seed(7), mu, logvar)
    eps = torch.randn(3, 5, generator=torch.Generator().manual_seed(7))
    assert torch.equal(z, mu + torch.exp(0.5 * logvar) * eps)
