"""The port's discriminator variants and their building blocks against the
JAX package, fp32 on the CPU.

The five classes of models/discriminator_variants.py (the temporal
PatchGANs, the layout-conditioned multiscale PatchGAN, the crop
classifier and the crop discriminator), `SpecCNN` over a spec with C, R, P,
U and FC in each of its norms, `SNDense` with its state after two calls,
and `global_avg_pool`. The weights are the port's seeded init carried into
the JAX tree (`weights.to_flax` on a `jax.eval_shape` template: no init
compiles), their constant leaves perturbed, and loaded back into a fresh
port module by `weights.from_flax`, strictly. Checked: the eval-mode
outputs; the train-mode outputs, the state they write (spectral `u` and
sigma, BatchNorm statistics) and the gradients of a fixed random weighting
of every float output w.r.t. every parameter and the images.

Bounds, as tests/test_torch_discriminator.py states them: features and
losses rtol = atol = 1e-5 (fp32, the same function: summation order
only); state rtol 1e-5, atol 1e-6; each gradient leaf within 1e-3 of its
largest JAX value plus 1e-6, or, where the JAX gradient is zero up to
rounding (a bias before a train-mode BatchNorm), at most 1e-5 of the
tree's largest gradient on both sides. `MultiscaleDiscriminator` rasterizes
with the plain version here (one call per forward, no kernel launch). The
JAX side is jitted, the eval forward and the train gradient in one call:
one compile of the whole costs less on the CPU than JAX's op-by-op
compiles, and less than two.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.models import discriminator_variants as jv
from ag2video_tpu.models.layers import SpecCNN as JSpecCNN
from ag2video_tpu.models.layers import global_avg_pool as j_global_avg_pool
from ag2video_tpu.models.normalization import SNDense as JSNDense
from ag2video_tpu.vocab import get_vocab
from ag2video_torch.models import discriminator_variants as tv
from ag2video_torch.models.layers import SpecCNN, global_avg_pool
from ag2video_torch.models.normalization import SNDense
from ag2video_torch.ops.rasterize import KERNEL_LAUNCHES, PLAIN_CALLS
from ag2video_torch.weights import (flax_to_state_dict, from_flax,
                                    init_params, to_flax)
from tests.test_torch_generation import _perturb

torch.set_num_threads(2)

FEAT_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
# A conv bias before a train-mode BatchNorm (which subtracts the batch
# mean) has a gradient of exactly zero; both sides give rounding noise
# there. A leaf whose JAX gradient is at most ZERO_REL of the largest in
# the tree is held to be zero on the port's side too, to the same bound.
ZERO_REL = 1e-5
STATE_LEAVES = (".u", ".sigma", ".running_mean", ".running_var")
# n_layers_D=2: one spectral-instance NormConv per PatchGAN (the PatchGAN
# itself is held deeper by tests/test_torch_discriminator.py); a smaller
# graph compiles faster.
D_WIDTHS = dict(ndf=8, n_layers_D=2)
ARCH = "C4-8-2,C4-16-2"  # the crop CNN, narrowed


def carry(jm, make_tm, jargs, seed, **kw):
    """(variables, port module): the port's seeded weights in JAX's tree,
    perturbed, loaded strictly into a fresh port module."""
    src = init_params(make_tm(), seed)
    template = jax.eval_shape(lambda k: jm.init(k, *jargs, **kw),
                              jax.random.PRNGKey(0))
    variables = _perturb(to_flax(template, src.state_dict()),
                         np.random.RandomState(seed))
    return variables, from_flax(variables, make_tm())


def float_leaves(out):
    """The floating-point arrays / tensors of a nested output, in order."""
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in float_leaves(o)]
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    a = jnp.asarray(out)
    return [a] if jnp.issubdtype(a.dtype, jnp.floating) else []


def assert_outputs(got, want, tol=FEAT_TOL):
    got, want = float_leaves(got), float_leaves(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **tol)


def _assert_grad(got, want, name):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= GRAD_RTOL * float(np.abs(want).max()) + GRAD_ATOL, name


def j_eval(jm, variables, *jargs):
    """The JAX module's eval-mode output, jitted (one compile of the whole
    forward costs less on the CPU than JAX's op-by-op compiles)."""
    return jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(variables,
                                                               *jargs)


def check_module(jm, variables, jargs, tm, targs, wrt, seed=2):
    """Eval mode, then train=True, on both sides (the JAX side in one
    jitted call): the eval outputs; the train outputs, the state written,
    and the gradients of sum_i <out_i, r_i> w.r.t. the params and
    jargs[wrt] -> (state leaves checked, the port's eval output, JAX's)."""
    state = {k: v for k, v in variables.items() if k != "params"}
    mutable = list(state) or False
    rng = np.random.RandomState(seed)
    # The output shapes by tracing alone: no compile.
    rs = [np.asarray(rng.randn(*a.shape), np.float32) for a in jax.tree.leaves(
        jax.eval_shape(lambda v: jm.apply(v, *jargs, train=False), variables))
        if jnp.issubdtype(a.dtype, jnp.floating)]

    def f(params, *xs):
        args = list(jargs)
        for i, x in zip(wrt, xs):
            args[i] = x
        res = jm.apply({"params": params, **state}, *args, train=True,
                       mutable=mutable)
        out, new = res if mutable else (res, {})
        total = sum(jnp.sum(x * r) for x, r in zip(float_leaves(out), rs))
        return total, (out, new)

    def both(variables, *xs):
        return (jm.apply(variables, *jargs, train=False),
                jax.value_and_grad(f, argnums=tuple(range(1 + len(wrt))),
                                   has_aux=True)(variables["params"], *xs))

    j_eval_out, ((_, (j_out, new)), grads) = jax.jit(both)(
        variables, *[jargs[i] for i in wrt])

    with torch.no_grad():  # before the train step writes the state
        t_eval_out = tm(*targs)
    assert_outputs(t_eval_out, j_eval_out)
    targs = list(targs)
    for i in wrt:
        targs[i] = targs[i].clone().requires_grad_(True)
    t_out = tm(*targs, train=True)
    assert_outputs(t_out, j_out)
    sum((x * torch.from_numpy(r)).sum()
        for x, r in zip(float_leaves(t_out), rs)).backward()

    want_state = flax_to_state_dict({"params": variables["params"], **new})
    n_state = 0
    for k, v in tm.state_dict().items():
        if k.endswith(STATE_LEAVES):
            np.testing.assert_allclose(v.numpy(), want_state[k].numpy(),
                                       err_msg=k, **STATE_TOL)
            n_state += 1
    assert n_state == sum(len(jax.tree.leaves(t)) for t in new.values())
    for i, g in zip(wrt, grads[1:]):
        _assert_grad(targs[i].grad, g, f"input {i}")
    want = flax_to_state_dict({"params": grads[0]})
    assert set(want) == {k for k, _ in tm.named_parameters()}
    zero = ZERO_REL * max(float(w.abs().max()) for w in want.values())
    for k, p in tm.named_parameters():
        if float(want[k].abs().max()) <= zero:  # analytically zero
            assert float(p.grad.abs().max()) <= zero, k
        else:
            _assert_grad(p.grad, want[k], k)
    return n_state, t_eval_out, j_eval_out


@pytest.fixture(scope="module")
def data():
    vocab = get_vocab("cater")
    rng = np.random.RandomState(0)
    B, T, O, H = 2, 3, 5, 32
    objs = rng.randint(1, 3, (B, O, len(vocab["attributes"])))
    objs[:, -1] = 0                # the dummy object: masked
    lo = rng.uniform(-0.1, 0.7, (B, T, O, 2))
    ext = rng.uniform(0.1, 0.6, (B, T, O, 2))
    boxes = np.concatenate([lo, ext], -1).astype(np.float32)
    boxes[0, 1, 2] = 0.0           # an all-zero box
    frames = rng.randn(B, T, H, H, 3).astype(np.float32)
    return dict(vocab=vocab, objs=objs, boxes=boxes, frames=frames)


def _run_variant(jm, make_tm, jargs, targs, wrt, seed):
    variables, tm = carry(jm, make_tm, jargs, seed)
    return check_module(jm, variables, jargs, tm, targs, wrt)[0]


def test_temporal_patchgan_matches(data):
    f = data["frames"]
    n = _run_variant(jv.NLayerDiscriminatorTM(**D_WIDTHS),
                     lambda: tv.NLayerDiscriminatorTM(3, **D_WIDTHS),
                     (jnp.asarray(f),), (torch.from_numpy(f),), (0,), 3)
    assert n == 2 * (D_WIDTHS["n_layers_D"] - 1)


def test_stack_frames_is_channel_c_plus_3t(data):
    f = torch.from_numpy(data["frames"])
    x = tv.stack_frames(f)
    for t in range(3):
        for c in range(3):
            assert torch.equal(x[..., c + 3 * t], f[:, t, ..., c])


def test_multiscale_temporal_matches(data):
    f = data["frames"]
    n = _run_variant(jv.MultiscaleDiscriminatorT(num_D=2, **D_WIDTHS),
                     lambda: tv.MultiscaleDiscriminatorT(3, 2, **D_WIDTHS),
                     (jnp.asarray(f),), (torch.from_numpy(f),), (0,), 4)
    assert n == 2 * 2 * (D_WIDTHS["n_layers_D"] - 1)


def test_layout_multiscale_discriminator_matches(data):
    vocab = data["vocab"]
    args = (data["frames"], data["objs"], data["boxes"])
    PLAIN_CALLS.reset()
    KERNEL_LAUNCHES.reset()
    n = _run_variant(
        jv.MultiscaleDiscriminator(vocab=vocab, embedding_dim=8, num_D=2,
                                   **D_WIDTHS),
        lambda: tv.MultiscaleDiscriminator(vocab, 8, 2, **D_WIDTHS),
        tuple(jnp.asarray(a) for a in args),
        tuple(torch.from_numpy(a) for a in args), (0,), 5)
    assert n == 2 * 2 * (D_WIDTHS["n_layers_D"] - 1)
    # One rasterization per forward (eval, then train), all plain.
    assert (PLAIN_CALLS.n, KERNEL_LAUNCHES.n) == (2, 0)


def test_crop_classifier_matches(data):
    vocab = data["vocab"]
    rng = np.random.RandomState(1)
    crops = rng.randn(7, 16, 16, 3).astype(np.float32)
    attr = rng.randint(0, 3, (7, 4)).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 0, 1, 1], np.float32)
    jm = jv.AcAttDiscriminator(vocab=vocab, arch=ARCH)
    args = (crops, attr, mask)
    variables, tm = carry(jm, lambda: tv.AcAttDiscriminator(vocab, ARCH),
                          tuple(jnp.asarray(a) for a in args), 6)
    targs = tuple(torch.from_numpy(a) for a in args)
    with torch.no_grad():  # eval mode, before the train step writes state
        # No mask: every crop weighs 1.
        assert_outputs(tm(*targs[:2]), j_eval(
            jm, variables, jnp.asarray(crops), jnp.asarray(attr)))
        # All masked: the denominator is clipped to 1, the loss is 0.
        _, loss = tm(*targs[:2], torch.zeros(7))
        assert float(loss) == 0.0
    check_module(jm, variables, tuple(jnp.asarray(a) for a in args), tm,
                 targs, (0,))


def test_crop_discriminator_matches(data):
    vocab = data["vocab"]
    args = (data["frames"], data["objs"], data["boxes"])
    jm = jv.AcCropDiscriminator(vocab=vocab, object_size=8, arch=ARCH)
    jargs = tuple(jnp.asarray(a) for a in args)
    variables, tm = carry(jm, lambda: tv.AcCropDiscriminator(vocab, 8, ARCH),
                          jargs, 7)
    targs = tuple(torch.from_numpy(a) for a in args)
    _, got, want = check_module(jm, variables, jargs, tm, targs, (0,))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # 2 * 3 * 5 slots: the dummy object in 6 frames and one zero box.
    assert got[0].shape == (30, 1) and int(got[3].sum()) == 30 - 6 - 1


# A first conv at stride 2 ('SAME'), a residual block, both pools, an
# upsample, a conv after a norm, and two FCs on an NHWC flatten.
SPEC = "I3,C3-8-2,R,P2,U2,C3-4-1,P2,FC-64-10,FC-10-5"


@pytest.mark.parametrize("normalization,activation,pooling", [
    ("batch", "relu", "max"), ("instance", "leakyrelu-0.2", "avg"),
    ("none", "tanh", "max")])
def test_speccnn_matches(normalization, activation, pooling):
    rng = np.random.RandomState(8)
    x = rng.randn(3, 16, 16, 3).astype(np.float32)
    kw = dict(normalization=normalization, activation=activation,
              pooling=pooling)
    jm = JSpecCNN(arch=SPEC, **kw)
    variables, tm = carry(jm, lambda: SpecCNN(SPEC, **kw),
                          (jnp.asarray(x),), 9, train=True)
    n, got, _ = check_module(jm, variables, (jnp.asarray(x),), tm,
                             (torch.from_numpy(x),), (0,))
    assert got.shape == (3, 5)
    # Batch stats of the 3 norms: two in the residual block (a block after
    # the first conv is normed) and one before the second conv.
    assert n == (2 * 3 if normalization == "batch" else 0)


def test_speccnn_out_channels_and_bad_spec():
    for arch in (SPEC, ARCH, "I5,R", "C3-7,P2"):
        assert SpecCNN.out_channels(arch) == JSpecCNN.out_channels(arch)
    assert SpecCNN.out_channels("I5,R") == 5
    with pytest.raises(ValueError, match="Invalid layer spec"):
        SpecCNN("C3-8,X2")
    with pytest.raises(ValueError, match="normalization"):
        SpecCNN("C3-8,C3-8", normalization="layer")


@pytest.mark.parametrize("spectral", [True, False])
def test_sndense_matches_with_state(spectral):
    rng = np.random.RandomState(10)
    xs = [rng.randn(4, 5).astype(np.float32) for _ in range(2)]
    jm = JSNDense(features=6, spectral=spectral)
    variables, tm = carry(jm, lambda: SNDense(5, 6, spectral=spectral),
                          (jnp.asarray(xs[0]),), 11)
    params = variables["params"]
    state = {k: v for k, v in variables.items() if k != "params"}
    assert bool(state) == spectral
    for x in xs:  # two train calls, each writing the state
        if spectral:
            want, state = jm.apply({"params": params, **state},
                                   jnp.asarray(x), train=True,
                                   mutable=["spectral"])
        else:
            want = jm.apply(variables, jnp.asarray(x), train=True)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FEAT_TOL)
    if spectral:
        want_state = flax_to_state_dict({"params": params, **state})
        for k in ("spectral.u", "spectral.sigma"):
            np.testing.assert_allclose(tm.state_dict()[k].numpy(),
                                       want_state[k].numpy(), **STATE_TOL)
        # eval mode reads the state and writes none
        u = tm.spectral.u.clone()
        with torch.no_grad():
            got = tm(torch.from_numpy(xs[0]))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jm.apply({"params": params, **state},
                                             jnp.asarray(xs[0]),
                                             train=False)), **FEAT_TOL)
        assert torch.equal(u, tm.spectral.u)


def test_global_avg_pool_matches():
    x = np.random.RandomState(12).randn(2, 3, 5, 7, 4).astype(np.float32)
    np.testing.assert_allclose(
        global_avg_pool(torch.from_numpy(x)).numpy(),
        np.asarray(j_global_avg_pool(jnp.asarray(x))), **FEAT_TOL)
