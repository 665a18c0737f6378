"""The port's functional GAN losses, gradient penalty, KL divergence and
masked L1 against the JAX package, fp32 on the CPU.

`kld_loss`, `masked_l1_loss`, the six functional pairs (gan / wgan / lsgan,
g and d) with `get_gan_losses` (and its error on a bad name), and
`gradient_penalty`: on a linear scorer against the closed form
(mean((||w|| - gamma)^2) / gamma^2, whatever eps is drawn), on a small
conv scorer with the interpolation weights eps drawn by JAX and injected
(`gan._penalty_at`) against the JAX value, and its gradient w.r.t. the
scorer's weights against `jax.grad` (the input gradient keeps its graph).

Bounds: rtol = atol = 1e-5 on values (fp32, the same arithmetic), and 1e-4
relative on the penalty's weight gradient (a second derivative through the
conv, summed in other orders).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from ag2video_tpu.losses import gan as jgan
from ag2video_tpu.losses import perceptual as jperc
from ag2video_torch.losses import gan as tgan
from ag2video_torch.losses import get_gan_losses
from ag2video_torch.losses import perceptual as tperc

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_kld_and_masked_l1_match(rng):
    mu = rng.randn(3, 8).astype(np.float32)
    logvar = rng.randn(3, 8).astype(np.float32) * 0.5
    np.testing.assert_allclose(
        float(tperc.kld_loss(_t(mu), _t(logvar))),
        float(jperc.kld_loss(jnp.asarray(mu), jnp.asarray(logvar))), **TOL)
    x, y = (rng.randn(2, 2, 5, 6, 3).astype(np.float32) for _ in range(2))
    mask = (rng.rand(2, 2, 5, 6, 1) > 0.5).astype(np.float32)
    got = tperc.masked_l1_loss(_t(x), _t(y), _t(mask))
    want = jperc.masked_l1_loss(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # The mean runs over every element, the masked-out ones included.
    np.testing.assert_allclose(
        float(got), float(np.abs((x - y) * mask).sum() / x.size), **TOL)


@pytest.mark.parametrize("name", ["gan", "wgan", "lsgan"])
def test_functional_pairs_match(rng, name):
    real = (rng.randn(4, 1, 3, 3) * 2).astype(np.float32)
    fake = (rng.randn(4, 1, 3, 3) * 2).astype(np.float32)
    tg, td = get_gan_losses(name)
    jg, jd = jgan.get_gan_losses(name)
    assert tg is getattr(tgan, f"{name}_g_loss")
    assert td is getattr(tgan, f"{name}_d_loss")
    np.testing.assert_allclose(float(tg(_t(fake))),
                               float(jg(jnp.asarray(fake))), **TOL)
    np.testing.assert_allclose(
        float(td(_t(real), _t(fake))),
        float(jd(jnp.asarray(real), jnp.asarray(fake))), **TOL)


def test_get_gan_losses_rejects_bad_name():
    for get in (get_gan_losses, jgan.get_gan_losses):
        with pytest.raises(ValueError, match="Unrecognized GAN type"):
            get("hinge")


def test_gradient_penalty_linear_closed_form(rng):
    w = rng.randn(2, 3, 4).astype(np.float32)
    real = _t(rng.randn(5, 2, 3, 4).astype(np.float32))
    fake = _t(rng.randn(5, 2, 3, 4).astype(np.float32))
    norm = float(np.linalg.norm(w))
    for gamma in (1.0, 2.0):
        got = tgan.gradient_penalty(real, fake, lambda x: (x * _t(w)).sum(
            (1, 2, 3)), torch.Generator().manual_seed(0), gamma)
        np.testing.assert_allclose(float(got),
                                   (norm - gamma) ** 2 / gamma ** 2,
                                   rtol=1e-5)


def _scorer_weights(rng):
    return (rng.randn(3, 3, 3, 4).astype(np.float32) * 0.3,   # HWIO
            rng.randn(4).astype(np.float32) * 0.1)


def _j_scorer(k, b):
    def f(x):
        y = jax.lax.conv_general_dilated(
            x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jnp.tanh(y + b)  # (N, H, W, 4): averaged per sample
    return f


def _t_scorer(k, b):
    def f(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b,
                     padding=1)
        return torch.tanh(y).permute(0, 2, 3, 1)
    return f


def test_gradient_penalty_conv_scorer_matches_jax(rng):
    real = rng.randn(3, 6, 6, 3).astype(np.float32)
    fake = rng.randn(3, 6, 6, 3).astype(np.float32)
    k, b = _scorer_weights(rng)
    key = jax.random.PRNGKey(4)
    gamma = 1.5

    def j_pen(k, b):
        return jgan.gradient_penalty(jnp.asarray(real), jnp.asarray(fake),
                                     _j_scorer(k, b), key, gamma)

    want, (gk, gb) = jax.jit(jax.value_and_grad(j_pen, argnums=(0, 1)))(
        jnp.asarray(k), jnp.asarray(b))
    # The JAX draw of eps, injected into the port's penalty.
    eps = np.asarray(jax.random.normal(key, (3, 1, 1, 1), jnp.float32))
    x_hat = _t(eps * real + (1 - eps) * fake)
    tk, tb = _t(k).requires_grad_(True), _t(b).requires_grad_(True)
    got = tgan._penalty_at(x_hat, _t_scorer(tk, tb), gamma)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    got.backward()
    for t, j in ((tk.grad, gk), (tb.grad, gb)):
        j = np.asarray(j)
        err = float(np.abs(t.numpy() - j).max())
        assert err <= 1e-4 * float(np.abs(j).max()) + 1e-7
    assert float(np.abs(np.asarray(gk)).max()) > 1e-3  # a real gradient


def test_gradient_penalty_trains_through_inputs(rng):
    """The penalty's gradient reaches the fake images too, and under
    no_grad it is a plain value."""
    real = _t(rng.randn(2, 4, 4, 3).astype(np.float32))
    fake = _t(rng.randn(2, 4, 4, 3).astype(np.float32)).requires_grad_(True)
    k, b = (_t(a) for a in _scorer_weights(rng))
    pen = tgan.gradient_penalty(real, fake, _t_scorer(k, b),
                                torch.Generator().manual_seed(1))
    g, = torch.autograd.grad(pen, fake)
    assert float(g.abs().max()) > 0
    pen = pen.detach()
    with torch.no_grad():
        again = tgan.gradient_penalty(real, fake, _t_scorer(k, b),
                                      torch.Generator().manual_seed(1))
    assert not again.requires_grad
    np.testing.assert_allclose(float(again), float(pen), rtol=1e-6)
