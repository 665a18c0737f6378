"""Train-mode norms of the port against the JAX package, fp32 on the CPU.

BatchNorm with batch statistics and flax's running-average update (momentum
0.99 in NormConv / FlowResBlock / FactorizedNormConv, 0.9 in the param-free
norm), the instance norm (eps 1e-6 in NormConv, 1e-5 in the param-free
norm) and the group norm, flax SpectralNorm's power iteration with its
gradient through sigma and its `u` / sigma update (written only when
`train`), the factorized frontend's own `spectral_normalize`, and the
frozen fp32 VGG19 of the perceptual loss. Each
module is initialised in JAX, its state perturbed
(tests/test_torch_generation.py::_perturb), loaded with weights.from_flax,
and run on the same numpy inputs; outputs, the state written and the
gradients of sum(out * r) are compared.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.models import factorized as jf
from ag2video_tpu.models.flow import FlowResBlock as JFlowResBlock
from ag2video_tpu.models.normalization import NormConv as JNormConv
from ag2video_tpu.models.normalization import ParamFreeNorm as JParamFreeNorm
from ag2video_tpu.models.normalization import SNConv as JSNConv
from ag2video_tpu.losses.perceptual import vgg_loss as j_vgg_loss
from ag2video_tpu.models.vgg import VGG19Features as JVGG
from ag2video_tpu.ops.rasterize import box_coverage as j_box_coverage
from ag2video_torch.models import factorized as tf
from ag2video_torch.losses.perceptual import vgg_loss
from ag2video_torch.models.flow import FlowResBlock
from ag2video_torch.models.normalization import (NormConv, ParamFreeNorm,
                                                 SNConv)
from ag2video_torch.models.vgg import VGG19Features
from ag2video_torch.weights import flax_to_state_dict, from_flax
from tests.test_torch_generation import _perturb

torch.set_num_threads(2)

# One fp32 module on both sides: summation order only.
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_LEAVES = ("running_mean", "running_var", "u", "sigma")


def _x(rng, shape, offset=0.5):
    """Inputs with a per-channel offset, so that the statistics are not
    centred at zero."""
    return (rng.randn(*shape) + offset * rng.randn(shape[-1])).astype(
        np.float32)


def _jax_train(module, variables, args, r):
    """(out, new state, grads of sum(out * r) w.r.t. params and args[0])
    of a flax module in train mode."""
    state = {k: v for k, v in variables.items() if k != "params"}

    def f(params, x):
        out, new = module.apply({"params": params, **state}, x, *args[1:],
                                train=True,
                                mutable=["batch_stats", "spectral"])
        return jnp.sum(out * r), (out, new)

    (_, (out, new)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], args[0])
    return np.asarray(out), new, gp, np.asarray(gx)


def _check_train(jm, tm, variables, args, rng, n_state):
    """Run both in train mode and compare outputs, the state written and the
    gradients. `n_state`: how many state leaves the step must write."""
    out_j, new_j, gp_j, gx_j = _jax_train(
        jm, variables, [jnp.asarray(a) for a in args],
        r := rng.randn(*jm.apply(variables, *map(jnp.asarray, args),
                                 train=False).shape).astype(np.float32))
    from_flax(variables, tm)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    xs = [torch.from_numpy(a) for a in args]
    xs[0].requires_grad_(True)
    out_t = tm(*xs, train=True)
    (out_t * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, **OUT_TOL)
    want = flax_to_state_dict({"params": variables["params"], **new_j})
    written = 0
    for k, v in tm.state_dict().items():
        if k.rsplit(".", 1)[-1] in STATE_LEAVES:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       err_msg=k, **STATE_TOL)
            written += not torch.equal(v, before[k])
    assert written == n_state
    np.testing.assert_allclose(xs[0].grad.numpy(), gx_j, **GRAD_TOL)
    grads = flax_to_state_dict({"params": gp_j})
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                   err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("norm,stride,n_state", [
    ("spectralsyncbatch", 1, 4), ("spectralsyncbatch", 2, 4),
    ("spectralinstance", 2, 2), ("syncbatch", 1, 2), ("instance", 1, 0)])
def test_normconv_train_matches(rng, norm, stride, n_state):
    """Batch statistics and the momentum-0.99 update, the eps-1e-6 instance
    norm, and the spectral norm's sigma gradient and state update."""
    x = _x(rng, (4, 12, 10, 5))
    jm = JNormConv(8, norm, 3, strides=stride)
    variables = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                 train=False), rng)
    _check_train(jm, NormConv(5, 8, norm, 3, stride=stride), variables,
                 [x], rng, n_state)


def test_discriminator_normconv_padding_matches(rng):
    """The discriminator's k4 NormConv with explicit ((2, 2), (2, 2))
    padding, spectral-instance, stride 2."""
    pad = ((2, 2), (2, 2))
    x = _x(rng, (3, 11, 9, 6))
    jm = JNormConv(7, "spectralinstance", 4, strides=2, padding=pad)
    variables = _perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                 train=False), rng)
    _check_train(jm, NormConv(6, 7, "spectralinstance", 4, 2, pad),
                 variables, [x], rng, 2)


@pytest.mark.parametrize("kind,n_state", [("syncbatch", 2), ("instance", 0),
                                          ("group", 0)])
def test_param_free_norm_train_matches(rng, kind, n_state):
    """Momentum 0.9 and eps 1e-5 (batch), eps 1e-5 (instance), 32 groups
    (group)."""
    x = _x(rng, (3, 6, 5, 64))
    jm = JParamFreeNorm(kind)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = _perturb(dict(variables, params={}), rng)
    tm = ParamFreeNorm(kind, 64)
    out_j, new_j = jm.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
    from_flax(variables, tm)
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = tm(xt, train=True)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               **OUT_TOL)
    want = flax_to_state_dict(dict(new_j))
    assert len(want) == n_state
    for k, v in want.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(),
                                   err_msg=k, **STATE_TOL)
    r = rng.randn(*x.shape).astype(np.float32)
    gx = jax.grad(lambda a: jnp.sum(jm.apply(
        variables, a, train=True, mutable=["batch_stats"])[0] * r))(
            jnp.asarray(x))
    (out_t * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)


def test_flow_resblock_train_matches(rng):
    x = _x(rng, (4, 6, 6, 8))
    jm = JFlowResBlock(8, "spectralsyncbatch")
    variables = _perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                 train=False), rng)
    _check_train(jm, FlowResBlock(8, "spectralsyncbatch"), variables, [x],
                 rng, 8)


def test_snconv_eval_takes_gradient_and_writes_nothing(rng):
    """train=False: one power iteration from the stored u, the gradient
    through sigma, no state written (the frozen D of the G step); then
    train=True writes u and sigma once."""
    x = _x(rng, (2, 7, 6, 4))
    jm = JSNConv(6, 3)
    variables = _perturb(jm.init(jax.random.PRNGKey(4), jnp.asarray(x),
                                 train=False), rng)
    r = rng.randn(2, 7, 6, 6).astype(np.float32)
    gp = jax.grad(lambda p: jnp.sum(jm.apply(
        {"params": p, "spectral": variables["spectral"]}, jnp.asarray(x),
        train=False) * r))(variables["params"])
    tm = from_flax(variables, SNConv(4, 6, 3))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    (tm(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    want = flax_to_state_dict({"params": gp})
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   err_msg=k, **GRAD_TOL)
    with torch.no_grad():
        tm(torch.from_numpy(x), train=True)
    assert not torch.equal(tm.spectral.u, before["spectral.u"])


def test_spectral_normalize_gradient_matches(rng):
    """The factorized frontend's own power iteration: the kernel's gradient
    through sigma, u and v carrying none."""
    K = rng.randn(3, 3, 8, 6).astype(np.float32)
    u = rng.randn(6).astype(np.float32)
    r = rng.randn(3, 3, 8, 6).astype(np.float32)
    gj = jax.grad(lambda k: jnp.sum(jf.spectral_normalize(
        k, jnp.asarray(u))[0] * r))(jnp.asarray(K))
    kt = torch.from_numpy(K).requires_grad_(True)
    (tf.spectral_normalize(kt, torch.from_numpy(u))[0]
     * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gj), **GRAD_TOL)


@pytest.mark.parametrize("norm,n_state", [("spectralsyncbatch", 3),
                                          ("spectralinstance", 1)])
def test_factorized_norm_conv_train_matches(rng, norm, n_state):
    """FactorizedNormConv in train mode: `u` written once, BN batch
    statistics (or the instance norm), the kernel's gradient. The port's
    module ends in the leaky ReLU that the JAX module's callers apply."""
    B, nF, O, D, H, W = 3, 2, 3, 16, 8, 7
    boxes = rng.uniform(0.0, 0.6, (B, nF, O, 4)).astype(np.float32)
    cov = np.asarray(j_box_coverage(jnp.asarray(boxes), H, W))
    vecs = rng.randn(B, nF, O, D).astype(np.float32)
    img = _x(rng, (B, H, W, 5))
    jm = jf.FactorizedNormConv(features=7, norm=norm, seg_dim=D, n_frames=nF)
    variables = _perturb(jm.init(
        jax.random.PRNGKey(5), jnp.asarray(cov), jnp.asarray(vecs),
        jnp.asarray(img), train=False), rng)

    class Wrapped:  # (vecs first, so its input gradient is compared)
        @staticmethod
        def apply(v, vecs, cov, img, **kw):
            out, new = jm.apply(v, cov, vecs, img, **kw)
            return jax.nn.leaky_relu(out, 0.2), new

    tm = tf.FactorizedNormConv(7, norm, D, nF, 5)
    out_j, new_j, gp_j, gv_j = _jax_train(
        Wrapped, variables, [jnp.asarray(vecs), jnp.asarray(cov),
                             jnp.asarray(img)],
        r := rng.randn(B, H, W, 7).astype(np.float32))
    from_flax(variables, tm)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    vt = torch.from_numpy(vecs).requires_grad_(True)
    out_t = tm(torch.from_numpy(cov), vt, torch.from_numpy(img), train=True)
    (out_t * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), out_j, **OUT_TOL)
    want = flax_to_state_dict({"params": variables["params"], **new_j})
    written = 0
    for k, v in tm.state_dict().items():
        if k.rsplit(".", 1)[-1] in STATE_LEAVES:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       err_msg=k, **STATE_TOL)
            written += not torch.equal(v, before[k])
    assert written == n_state
    np.testing.assert_allclose(vt.grad.numpy(), gv_j, **GRAD_TOL)
    grads = flax_to_state_dict({"params": gp_j})
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                   err_msg=k, **GRAD_TOL)


def test_vgg_loss_matches(rng):
    """VGG19 relu{1..5}_1 features (fp32, random weights loaded from the
    JAX init), the weighted L1 and its input gradient. The gradient of an
    L1 is a sign: elements where the two sides' features differ by rounding
    flip it, so the gradient is held at 1e-2 of its largest value (observed
    4e-3); the features and the loss at 1e-5."""
    x = rng.randn(2, 2, 32, 32, 3).astype(np.float32)
    y = rng.randn(2, 2, 32, 32, 3).astype(np.float32)
    jm = JVGG()
    variables = jm.init(jax.random.PRNGKey(5), jnp.asarray(x[0]))
    tm = from_flax(variables, VGG19Features())
    jf = jm.apply(variables, jnp.asarray(x[0]))
    tf = tm(torch.from_numpy(x[0]))
    assert len(tf) == 5 and not any(p.requires_grad for p in tm.parameters())
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-5)
    j_fn = lambda v: j_vgg_loss(lambda z: jm.apply(variables, z), v,
                                jnp.asarray(y))
    j_val, j_grad = jax.value_and_grad(j_fn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    t_val = vgg_loss(tm, xt, torch.from_numpy(y))
    t_val.backward()
    assert np.isclose(float(t_val), float(j_val), rtol=1e-5)
    j_grad = np.asarray(j_grad)
    assert np.abs(xt.grad.numpy() - j_grad).max() <= \
        1e-2 * np.abs(j_grad).max()
