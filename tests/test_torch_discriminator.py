"""The port's action-conditioned multiscale discriminator against the JAX
package, fp32 on the CPU.

`MultiscaleActionDiscriminator` at small widths (embedding and gconv 16,
ndf 8, num_D 2, n_layers_D 3: a stride-2 and the stride-1 spectral-instance
NormConv), initialised in JAX, its spectral state and biases perturbed,
loaded with weights.from_flax. Checked: every per-scale feature of the
single pass and of the batched real+fake (`img2`) pass, the gradients of
both passes w.r.t. every parameter and both image sets in train mode, and
the spectral state that pass writes (one power iteration per call). The
rasterizer call takes its plain version here, once per call.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.models.discriminator import \
    MultiscaleActionDiscriminator as JDisc
from ag2video_tpu.vocab import get_vocab
from ag2video_torch.models.discriminator import MultiscaleActionDiscriminator
from ag2video_torch.ops.rasterize import KERNEL_LAUNCHES, PLAIN_CALLS
from ag2video_torch.weights import flax_to_state_dict, from_flax
from tests.test_torch_generation import _perturb

torch.set_num_threads(2)

WIDTHS = dict(embedding_dim=16, gconv_dim=16, gconv_hidden_dim=32, num_D=2,
              n_layers_D=3, ndf=8)
# fp32, the same function: summation order only.
FEAT_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
# Per leaf: 1e-3 of the leaf's largest JAX gradient, plus 1e-6.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6


def _inputs(vocab, B=2, T=2, O=5, A=2, H=32, seed=0):
    rng = np.random.RandomState(seed)
    num_attr = len(vocab["attributes"])
    objs = rng.randint(1, 3, (B, O, num_attr))
    objs[:, -1] = 0  # the dummy object: not rasterized
    num_acts = len(vocab["action_idx_to_name"])
    tt = np.stack([rng.randint(0, O, (B, T, A)),
                   rng.randint(0, num_acts, (B, T, A)),
                   rng.randint(0, O, (B, T, A))], -1).astype(np.int32)
    actions_data = {
        "temporal_triplets": tt,
        "relative_timesteps": rng.uniform(0, 1, (B, T, A)).astype(
            np.float32),
        "locs": rng.uniform(-0.5, 0.5, (B, T, A, 2)).astype(np.float32),
    }
    boxes = rng.uniform(0.0, 0.6, (B, T, O, 4)).astype(np.float32)
    imgs = [rng.randn(B, T, H, H, 3).astype(np.float32) for _ in range(2)]
    return imgs, objs, boxes, actions_data


@pytest.fixture(scope="module")
def disc():
    vocab = get_vocab("cater")
    imgs, objs, boxes, ad = _inputs(vocab)
    jm = JDisc(vocab=vocab, **WIDTHS)
    j_args = (jnp.asarray(imgs[0]), jnp.asarray(objs), jnp.asarray(boxes),
              {k: jnp.asarray(v) for k, v in ad.items()})
    variables = _perturb(jm.init(jax.random.PRNGKey(0), *j_args,
                                 train=False), np.random.RandomState(1))
    tm = from_flax(variables, MultiscaleActionDiscriminator(vocab, **WIDTHS))
    t_args = (torch.from_numpy(imgs[0]), torch.from_numpy(objs),
              torch.from_numpy(boxes),
              {k: torch.from_numpy(v) for k, v in ad.items()})
    return dict(jm=jm, tm=tm, variables=variables, imgs=imgs, j_args=j_args,
                t_args=t_args)


def _assert_feats(got, want):
    assert len(got) == len(want) == WIDTHS["num_D"]
    for scale_t, scale_j in zip(got, want):
        assert len(scale_t) == len(scale_j) == WIDTHS["n_layers_D"] + 1
        for a, b in zip(scale_t, scale_j):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **FEAT_TOL)
    assert got[0][-1].dtype == torch.float32


def test_single_pass_features_match(disc):
    want = disc["jm"].apply(disc["variables"], *disc["j_args"], train=False)
    PLAIN_CALLS.reset()
    KERNEL_LAUNCHES.reset()
    with torch.no_grad():
        got = disc["tm"](*disc["t_args"])
    assert (PLAIN_CALLS.n, KERNEL_LAUNCHES.n) == (1, 0)
    _assert_feats(got, want)


def test_batched_pass_features_match(disc):
    img2 = disc["imgs"][1]
    want = disc["jm"].apply(disc["variables"], *disc["j_args"], train=False,
                            img2=jnp.asarray(img2))
    PLAIN_CALLS.reset()
    with torch.no_grad():
        got = disc["tm"](*disc["t_args"], img2=torch.from_numpy(img2))
        second = disc["tm"](torch.from_numpy(img2), *disc["t_args"][1:])
    assert PLAIN_CALLS.n == 2  # one rasterization per call
    _assert_feats(got[0], want[0])
    _assert_feats(got[1], want[1])
    # The batched call is two single calls (the instance norms have no
    # batch coupling).
    for a, b in zip(sum(got[1], []), sum(second, [])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FEAT_TOL)


def test_train_pass_gradients_and_state_match(disc):
    """train=True on the batched pass: gradients of sum(feat * r) over every
    feature w.r.t. every parameter and both image sets, and the spectral
    state written once."""
    jm, variables = disc["jm"], disc["variables"]
    img, img2 = disc["imgs"]
    rng = np.random.RandomState(2)
    rs = [rng.randn(*a.shape).astype(np.float32) for a in jax.tree.leaves(
        jm.apply(variables, *disc["j_args"], train=False,
                 img2=jnp.asarray(img2)))]
    state = {k: v for k, v in variables.items() if k != "params"}

    def f(params, a, b):
        feats, new = jm.apply({"params": params, **state}, a,
                              *disc["j_args"][1:], train=True, img2=b,
                              mutable=["spectral"])
        total = sum(jnp.sum(x * r) for x, r in
                    zip(jax.tree.leaves(feats), rs))
        return total, new

    (_, new), (gp, ga, gb) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            variables["params"], jnp.asarray(img), jnp.asarray(img2))

    tm = from_flax(variables, disc["tm"])
    ta = torch.from_numpy(img).requires_grad_(True)
    tb = torch.from_numpy(img2).requires_grad_(True)
    feats = tm(ta, *disc["t_args"][1:], train=True, img2=tb)
    flat = [x for half in feats for scale in half for x in scale]
    assert len(flat) == len(rs)
    sum((x * torch.from_numpy(r)).sum() for x, r in zip(flat, rs)).backward()

    want_state = flax_to_state_dict({"params": variables["params"], **new})
    n_spectral = 0
    for k, v in tm.state_dict().items():
        if k.endswith(".u") or k.endswith(".sigma"):
            np.testing.assert_allclose(v.numpy(), want_state[k].numpy(),
                                       err_msg=k, **STATE_TOL)
            n_spectral += 1
    assert n_spectral == 2 * WIDTHS["num_D"] * (WIDTHS["n_layers_D"] - 1)
    for t, j in ((ta, ga), (tb, gb)):
        j = np.asarray(j)
        err = np.abs(t.grad.numpy() - j).max()
        assert err <= GRAD_RTOL * np.abs(j).max() + GRAD_ATOL
    grads = flax_to_state_dict({"params": gp})
    assert set(grads) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        w = grads[k]
        err = float((p.grad - w).abs().max())
        assert err <= GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL, k
