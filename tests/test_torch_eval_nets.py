"""The port's evaluation networks against the JAX package's, fp32 on the
CPU: InceptionV3 (logits and pool3), AlexNet's five LPIPS stages and the
LPIPS distance, TSM-ResNet50 and ResNeXt3D (cut to one block per stage),
each at an even and an odd input size (flax's 'SAME' pads asymmetrically
at stride 2 on even sizes only), `temporal_shift`, and `resize_bilinear`
up and down against `jax.image.resize`.

Both sides hold the same variables: the JAX module's tree (its shapes from
`init`, traced with `jax.eval_shape`) filled with seeded values, the BN
scales, shifts, running means and variances perturbed off flax's defaults,
and carried to the port through the weight bridge (weights.from_flax,
strict)."""

from collections.abc import Mapping

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.eval import inception as ji
from ag2video_tpu.eval import lpips as jl
from ag2video_tpu.eval import video_backbones as jv
from ag2video_torch.eval import inception as ti
from ag2video_torch.eval import lpips as tl
from ag2video_torch.eval import video_backbones as tv
from ag2video_torch.weights import from_flax

torch.set_num_threads(2)

# The deep nets in fp32: XLA's CPU convs against PyTorch's sum in other
# orders (observed rel-L2 <= 7e-7 and max|diff| <= 7e-7 of max|ref|).
NET_REL_L2 = 1e-4
NET_MAX_REL = 1e-3
# AlexNet's stages and the LPIPS distance (observed <= 1.8e-6).
ALEX_RTOL = 1e-5
# resize_bilinear on unit-variance inputs: up 64 -> 299 (observed 4.3e-6)
# and down 320x240 -> 96 (observed 1.8e-7), absolute.
RESIZE_UP_ATOL = 1e-5
RESIZE_DOWN_ATOL = 1e-4


def fill(tree, seed=0):
    """Seeded values in the shapes of a flax variable tree: kernels
    N(0, 1/fan_in), biases and BN shifts N(0, 0.01), BN scales
    1 + N(0, 0.01), running means N(0, 0.01), variances U(0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def leaf(name, x):
        shape = tuple(x.shape)
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
                    ).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.randn(*shape)).astype(np.float32)

    def walk(node):
        return {k: walk(v) if isinstance(v, Mapping) else leaf(k, v)
                for k, v in sorted(node.items())}

    return walk(tree)


def variables(module, shape, seed=0):
    return fill(jax.eval_shape(module.init, jax.random.PRNGKey(0),
                               jnp.zeros(shape, jnp.float32)), seed)


def assert_net_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= NET_REL_L2 and worst <= NET_MAX_REL, (what, rel, worst)


@pytest.mark.parametrize("size", [96, 97])
def test_inception_v3_matches(size):
    model = ji.InceptionV3()
    v = variables(model, (1, size, size, 3))
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(np.float32)
    want_logits, want_pool3 = jax.jit(model.apply)(v, x)
    net = from_flax(v, ti.InceptionV3()).eval()
    with torch.no_grad():
        logits, pool3 = net(torch.from_numpy(x))
    assert logits.shape == (2, 1000) and pool3.shape == (2, 2048)
    assert_net_close(logits, want_logits, "logits")
    assert_net_close(pool3, want_pool3, "pool3")


def _lpips_asset(path, v, lins):
    data = {}
    for i in range(5):
        data[f"conv{i}_kernel"] = v["params"][f"conv{i}"]["kernel"]
        data[f"conv{i}_bias"] = v["params"][f"conv{i}"]["bias"]
        data[f"lin{i}"] = lins[i]
    np.savez(path, **data)


@pytest.mark.parametrize("size", [64, 63])
def test_alexnet_and_lpips_match(size, tmp_path):
    net = jl.AlexNetFeatures()
    v = variables(net, (1, size, size, 3))
    rng = np.random.RandomState(2)
    x, y = (rng.uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
            for _ in range(2))
    want = net.apply(v, x)
    port = from_flax(v, tl.AlexNetFeatures())
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=0,
            atol=ALEX_RTOL * float(np.abs(w).max()), err_msg=f"stage {i}")

    lins = [rng.uniform(0, 0.2, c).astype(np.float32)
            for c in tl.LPIPS.CHANNELS]
    path = str(tmp_path / "lpips_alex.npz")
    _lpips_asset(path, v, lins)
    j_lp, t_lp = jl.LPIPS(path), tl.LPIPS(path, device="cpu")
    assert not j_lp.random_init and not t_lp.random_init
    want_d, got_d = j_lp(x, y), t_lp(x, y)
    assert got_d.shape == (3,) and (got_d > 0).all()
    np.testing.assert_allclose(got_d, want_d, rtol=ALEX_RTOL)
    np.testing.assert_allclose(t_lp.video_pair_distance(x, y),
                               j_lp.video_pair_distance(x, y),
                               rtol=ALEX_RTOL)
    assert t_lp.video_pair_distance(x, x) == 0.0


def test_lpips_without_asset_is_random_init(tmp_path):
    lp = tl.LPIPS(str(tmp_path / "missing.npz"), device="cpu")
    assert lp.random_init
    for w, c in zip(lp.lin_weights, tl.LPIPS.CHANNELS):
        np.testing.assert_array_equal(w, np.full(c, 1.0 / c, np.float32))


@pytest.mark.parametrize("size", [64, 63])
def test_tsm_resnet50_matches(size):
    model = jv.TSMResNet50()
    v = variables(model, (1, 2, size, size, 3))
    x = np.random.RandomState(3).randn(1, 2, size, size, 3).astype(
        np.float32)
    want = jax.jit(model.apply)(v, x)
    with torch.no_grad():
        got = from_flax(v, tv.TSMResNet50())(torch.from_numpy(x))
    assert got.shape == (1, 2048)
    assert_net_close(got, want, "tsm")


@pytest.mark.parametrize("size", [32, 31])
def test_resnext3d_matches(size):
    model = jv.ResNeXt3D101(layers=(1, 1, 1, 1))
    v = variables(model, (1, 4, size, size, 3))
    x = np.random.RandomState(4).randn(1, 4, size, size, 3).astype(
        np.float32)
    want = jax.jit(model.apply)(v, x)
    port = from_flax(v, tv.ResNeXt3D101(layers=(1, 1, 1, 1)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (1, 2048)
    assert_net_close(got, want, "resnext3d")


@pytest.mark.parametrize("T", [1, 3])
def test_temporal_shift_is_exact(T):
    x = np.random.RandomState(5).randn(2 * T, 3, 4, 16).astype(np.float32)
    want = np.asarray(jv.temporal_shift(jnp.asarray(x), T))
    got = tv.temporal_shift(torch.from_numpy(x), T).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst,atol", [
    ((64, 64), (299, 299), RESIZE_UP_ATOL),
    ((240, 320), (96, 96), RESIZE_DOWN_ATOL)], ids=["up", "down"])
def test_resize_bilinear_matches_jax(src, dst, atol):
    x = np.random.RandomState(6).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(ji.resize_bilinear(jnp.asarray(x), dst))
    got = ti.resize_bilinear(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape == (2, *dst, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
