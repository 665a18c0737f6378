"""The port's grid sampling and box crops against the JAX package, fp32 on
the CPU.

`ops.sampling.grid_sample_2d` in both padding modes and both align_corners
settings, on grids that reach beyond [-1, 1], lie exactly on the border and
hold NaNs, with leading dims; its gradients w.r.t. the image and the grid;
`ops.crop.crop_bbox` and `crop_bbox_batch` with illegal slots (an all-zero
box and a masked object), whose crops are zero and whose legality mask is
exact. The port samples with `F.grid_sample`; the JAX package gathers and
lerps, so values agree to fp32 rounding: rtol = atol = 1e-5 (the crop grid
is computed exactly as JAX computes it, `ops.sampling.linspace01`). The
JAX side is jitted.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.ops import crop as jcrop
from ag2video_tpu.ops import sampling as jsampling
from ag2video_torch.ops import crop_bbox, crop_bbox_batch, grid_sample_2d
from ag2video_torch.ops.crop import crop_grid
from ag2video_torch.ops.sampling import linspace01

TOL = dict(rtol=1e-5, atol=1e-5)
# Jitted: one compile per shape costs less than JAX's op-by-op compiles.
j_grid_sample = jax.jit(jsampling.grid_sample_2d,
                        static_argnames=("align_corners", "padding_mode"))
j_crop_bbox = jax.jit(jcrop.crop_bbox, static_argnums=(2, 3))
j_crop_bbox_batch = jax.jit(jcrop.crop_bbox_batch, static_argnums=(2, 3))


def _grid(rng, lead, Ho, Wo):
    """Coordinates in [-1.6, 1.6], with exact border values (+-1) and
    corners (0 and +-1 together), and two NaNs (one in x, one in y)."""
    grid = rng.uniform(-1.6, 1.6, lead + (Ho, Wo, 2)).astype(np.float32)
    flat = grid.reshape(-1, 2)
    flat[0] = [-1.0, -1.0]
    flat[1] = [1.0, 1.0]
    flat[2] = [1.0, 0.3]
    flat[3] = [-0.2, -1.0]
    flat[4] = [np.nan, 0.1]
    flat[5] = [0.4, np.nan]
    flat[6] = [-1.0, 1.0]
    return grid


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_jax(rng, padding_mode, align_corners):
    img = rng.randn(2, 3, 9, 11, 4).astype(np.float32)
    grid = _grid(rng, (2, 3), 7, 5)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    want = np.asarray(j_grid_sample(jnp.asarray(img), jnp.asarray(grid),
                                    **kw))
    got = grid_sample_2d(torch.from_numpy(img), torch.from_numpy(grid), **kw)
    assert got.shape == want.shape == (2, 3, 7, 5, 4)
    # A NaN coordinate (x or y) gives a NaN pixel, and only there.
    nan_points = np.isnan(grid).any(-1)[..., None].repeat(4, -1)
    assert nan_points.sum() == 2 * 4
    np.testing.assert_array_equal(np.isnan(want), nan_points)
    np.testing.assert_array_equal(np.isnan(got.numpy()), nan_points)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_gradients_match_jax(rng, padding_mode):
    img = rng.randn(2, 6, 7, 3).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 4, 2)).astype(np.float32)
    r = rng.randn(2, 5, 4, 3).astype(np.float32)
    kw = dict(align_corners=True, padding_mode=padding_mode)

    def j_loss(i, g):
        return jnp.sum(j_grid_sample(i, g, **kw) * r)

    want = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(img),
                                                     jnp.asarray(grid))
    ti = torch.from_numpy(img).requires_grad_(True)
    tg = torch.from_numpy(grid).requires_grad_(True)
    (grid_sample_2d(ti, tg, **kw) * torch.from_numpy(r)).sum().backward()
    for got, w in zip((ti.grad, tg.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_grid_sample_rejects_other_padding():
    img, grid = torch.zeros(1, 4, 4, 1), torch.zeros(1, 2, 2, 2)
    with pytest.raises(ValueError, match="reflection"):
        grid_sample_2d(img, grid, padding_mode="reflection")
    with pytest.raises(ValueError, match="do not match"):
        grid_sample_2d(img, torch.zeros(2, 2, 2, 2))


def test_linspace01_is_jax_linspace():
    ns = (1, 2, 7, 16, 32, 33, 64, 256, 257)
    # Under jit, as the crops compute it (one compile for all sizes).
    wants = jax.jit(lambda: [jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)
                             for n in ns])()
    for n, want in zip(ns, wants):
        np.testing.assert_array_equal(linspace01(n).numpy(),
                                      np.asarray(want))


def _boxes(rng, shape):
    lo = rng.uniform(-0.2, 0.8, shape + (2,))
    ext = rng.uniform(0.05, 0.7, shape + (2,))
    return np.concatenate([lo, ext], -1).astype(np.float32)


@pytest.mark.parametrize("size", [(8, 8), (6, 10)])
def test_crop_bbox_matches_jax(rng, size):
    HH, WW = size
    feats = rng.randn(2, 3, 16, 20, 5).astype(np.float32)
    bbox = _boxes(rng, (2, 3))
    bbox[0, 0] = [0.0, 0.0, 1.0, 1.0]  # the whole image
    want = np.asarray(j_crop_bbox(jnp.asarray(feats), jnp.asarray(bbox),
                                  HH, WW))
    got = crop_bbox(torch.from_numpy(feats), torch.from_numpy(bbox), HH, WW)
    assert got.shape == want.shape == (2, 3, HH, WW, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The whole-image box at the image's own size gives the image back.
    same = crop_bbox(torch.from_numpy(feats[:1, :1]),
                     torch.tensor([[[0.0, 0.0, 1.0, 1.0]]]), 16, 20)
    np.testing.assert_allclose(same.numpy(), feats[:1, :1], **TOL)


def test_crop_bbox_batch_matches_jax_with_illegal_slots(rng):
    B, T, O, S = 2, 3, 4, 8
    imgs = rng.randn(B, T, 24, 20, 3).astype(np.float32)
    bbox = _boxes(rng, (B, T, O))
    bbox[0, 1, 2] = 0.0            # an all-zero box: illegal in that frame
    mask = np.ones((B, O), np.float32)
    mask[1, 3] = 0.0               # a masked object: illegal in every frame
    want_crops, want_legal = j_crop_bbox_batch(
        jnp.asarray(imgs), jnp.asarray(bbox), S, None, jnp.asarray(mask))
    crops, legal = crop_bbox_batch(torch.from_numpy(imgs),
                                   torch.from_numpy(bbox), S,
                                   mask=torch.from_numpy(mask))
    assert crops.shape == want_crops.shape == (B, T, O, S, S, 3)
    np.testing.assert_array_equal(legal.numpy(), np.asarray(want_legal))
    assert int(legal.sum()) == B * T * O - 1 - T
    np.testing.assert_allclose(crops.numpy(), np.asarray(want_crops), **TOL)
    assert not crops[0, 1, 2].any() and not crops[1, :, 3].any()
    # Without a mask only the all-zero box is illegal.
    _, legal = crop_bbox_batch(torch.from_numpy(imgs), torch.from_numpy(bbox),
                               S, 6)
    assert int(legal.sum()) == B * T * O - 1


def test_crop_bbox_batch_is_one_crop_per_slot(rng):
    """Folding the objects into the grid's rows is the per-slot crop."""
    imgs = torch.from_numpy(rng.randn(1, 2, 12, 12, 2).astype(np.float32))
    bbox = torch.from_numpy(_boxes(rng, (1, 2, 3)))
    crops, _ = crop_bbox_batch(imgs, bbox, 5, 7)
    for t in range(2):
        for o in range(3):
            one = crop_bbox(imgs[0, t], bbox[0, t, o], 5, 7)
            assert torch.equal(crops[0, t, o], one)
    assert crop_grid(bbox, 5, 7).shape == (1, 2, 3, 5, 7, 2)
