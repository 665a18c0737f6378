"""The port's factorized (object-basis) frontend, the default configuration,
against the JAX package, fp32 on the CPU.

Module by module (ag2video_torch/models/factorized.py and
FlowsGenerator(skip_first=True)), then the default configuration's
generation at 32x32 (factorized_frontend=True), the port's own
dense == factorized identity (chip_smoke.py phase 6a, rehearsed here), and
the committed reference file that chip_smoke.py holds the card to.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.config import Config
from ag2video_tpu.models import factorized as jf
from ag2video_tpu.models.flow import FlowsGenerator as JFlows
from ag2video_tpu.models.meta import AG2VideoModel as JModel
from ag2video_tpu.ops.rasterize import box_coverage as j_box_coverage
from ag2video_tpu.vocab import get_vocab
from ag2video_torch.flax_npz import flatten_variables, unflatten_variables
from ag2video_torch.inference import make_inputs
from ag2video_torch.models import AG2VideoModel
from ag2video_torch.models import factorized as tf
from ag2video_torch.models.flow import FlowsGenerator
from ag2video_torch.weights import (flax_to_state_dict, from_flax,
                                    load_flax_npz)
from tests.test_torch_generation import (BOX_TOL, FRAME_TOL, KEYS, SMALL,
                                         _perturb)

torch.set_num_threads(2)

# One fp32 module on both sides: summation order only.
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
DEFAULT_SMALL = dict(SMALL, factorized_frontend=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _window(rng, B=2, nF=2, O=3, D=16, H=12, W=10, img_ch=3):
    boxes = rng.uniform(0.1, 0.5, (B, nF, O, 4)).astype(np.float32)
    mask = (rng.uniform(size=(B, nF, O)) > 0.2).astype(np.float32)
    cov = np.asarray(j_box_coverage(jnp.asarray(boxes), H, W,
                                    jnp.asarray(mask)))
    vecs = rng.randn(B, nF, O, D).astype(np.float32)
    img = rng.randn(B, H, W, img_ch).astype(np.float32)
    return cov, vecs, img


def test_spectral_normalize_matches(rng):
    """eps added to the norm, u of shape (features,), sigma = v^T K u after
    one iteration; atol 1e-6."""
    K = rng.randn(3, 3, 8, 6).astype(np.float32)
    u = rng.randn(6).astype(np.float32)
    jk, ju = jf.spectral_normalize(jnp.asarray(K), jnp.asarray(u))
    tk, tu = tf.spectral_normalize(_t(K), _t(u))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-6)


@pytest.mark.parametrize("ks,shape", [(3, (2, 4, 7, 5)), (5, (1, 3, 6, 6))])
def test_shifted_stack_is_exact(rng, ks, shape):
    x = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jf.shifted_stack(jnp.asarray(x), ks))
    got = tf.shifted_stack(_t(x), ks).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_object_basis_conv_matches(rng):
    cov, _, _ = _window(rng)
    cov = cov.reshape(2, 6, 12, 10)
    wk = rng.randn(2, 6, 9, 8).astype(np.float32)
    want = np.asarray(jf.object_basis_conv(jnp.asarray(cov), jnp.asarray(wk)))
    got = tf.object_basis_conv(_t(cov), _t(wk))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


@pytest.mark.parametrize("norm", ["spectralsyncbatch", "syncbatch",
                                  "spectral", "none"])
def test_factorized_norm_conv_matches(rng, norm):
    """JAX params with perturbed BN statistics, scales, biases and `u`,
    loaded through from_flax. The port's module ends in the leaky ReLU that
    the JAX module's callers apply."""
    cov, vecs, img = _window(rng, img_ch=5)
    jm = jf.FactorizedNormConv(features=7, norm=norm, seg_dim=16, n_frames=2)
    args = (jnp.asarray(cov), jnp.asarray(vecs), jnp.asarray(img))
    variables = jm.init(jax.random.PRNGKey(0), *args, train=False)
    variables = _perturb(variables, rng)
    want = np.asarray(jax.nn.leaky_relu(
        jm.apply(variables, *args, train=False), 0.2))
    tm = tf.FactorizedNormConv(7, norm, 16, 2, 5).eval()
    from_flax(variables, tm)
    with torch.no_grad():
        got = tm(_t(cov), _t(vecs), _t(img))
    assert tuple(got.shape) == want.shape == (2, 12, 10, 7)
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


def test_flows_generator_skip_first_matches(rng):
    """The first NormConv does not exist at all: the JAX variables load
    strictly, with no leftover down_0."""
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    jm = JFlows(nff=4, n_blocks_F=1, n_downsample_F=2, skip_first=True)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    variables = _perturb(variables, rng)
    j_weight, j_flow = jm.apply(variables, jnp.asarray(x), train=False)
    tm = FlowsGenerator(None, nff=4, n_blocks_F=1, n_downsample_F=2,
                        skip_first=True).eval()
    assert not any(k.startswith("down_0") for k in tm.state_dict())
    from_flax(variables, tm)
    with torch.no_grad():
        t_weight, t_flow = tm(_t(x))
    np.testing.assert_allclose(t_flow.numpy(), np.asarray(j_flow),
                               **MODULE_TOL)
    np.testing.assert_allclose(t_weight.numpy(), np.asarray(j_weight),
                               **MODULE_TOL)


@pytest.fixture(scope="module")
def default_outputs():
    """The default configuration (factorized frontend) at 32x32, JAX
    variables perturbed, loaded into the port through from_flax."""
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", **DEFAULT_SMALL).derive(vocab)
    assert cfg.factorized_frontend
    batch = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    args = tuple(jnp.asarray(batch[k]) for k in KEYS)
    jm = JModel(config=cfg, vocab=vocab)
    variables = jax.jit(lambda k: jm.init({"params": k}, *args, use_gt=True,
                                          train=False))(jax.random.PRNGKey(0))
    variables = _perturb(variables, np.random.RandomState(1))
    j_out = jax.jit(lambda v: jm.apply(v, *args, test_mode=True,
                                       use_gt=False, train=False))(variables)
    tm = AG2VideoModel(cfg, vocab, device="cpu")
    from_flax(variables, tm)
    with torch.no_grad():
        t_out = tm(*(torch.as_tensor(batch[k]) for k in KEYS))
    return dict(cfg=cfg, vocab=vocab, variables=variables, j=j_out, t=t_out,
                model=tm)


@pytest.mark.parametrize("key", ["imgs_pred", "flows_pred"])
def test_default_config_frames_match(default_outputs, key):
    j, t = default_outputs["j"], default_outputs["t"]
    assert t[key].shape[:4] == (2, 3, 32, 32)
    np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]),
                               **FRAME_TOL)


def test_default_config_boxes_match(default_outputs):
    j, t = default_outputs["j"], default_outputs["t"]
    np.testing.assert_allclose(t["boxes_pred"].numpy(),
                               np.asarray(j["boxes_pred"]), **BOX_TOL)


def test_default_config_conf_match(default_outputs):
    """conf is a hard threshold: at most 0.1% of pixels may flip."""
    j, t = default_outputs["j"], default_outputs["t"]
    assert (t["conf_pred"].numpy() != np.asarray(j["conf_pred"])).mean() \
        <= 1e-3


def test_default_config_bridge(default_outputs, tmp_path):
    """The factorized modules' `u` map to port buffers; every leaf is used
    and every tensor filled; the .npz round trip (flax's slashed
    'conv/kernel/u' keys included) gives the same state; a spectral leaf
    of no known form still raises."""
    variables, model = default_outputs["variables"], default_outputs["model"]
    converted = flax_to_state_dict(variables)
    state = model.state_dict()
    assert set(converted) == set(state)
    fs = "layout_to_video.frame_step."
    for name in ("flow_down_0.u", "conv_dim_in.u", "flow_down_0.weight",
                 "conv_dim_in.norm.running_var"):
        np.testing.assert_array_equal(state[fs + name].numpy(),
                                      converted[fs + name].numpy())
    assert not any(k.startswith(fs + "flows_network.down_0") for k in state)

    path = tmp_path / "itr_3.npz"
    np.savez(path, **flatten_variables(variables))
    assert any(k.endswith("SpectralNorm_0/conv/kernel/u")
               for k in np.load(path).files)
    again = load_flax_npz(str(path), AG2VideoModel(
        default_outputs["cfg"], default_outputs["vocab"], device="cpu"))
    for k, v in again.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)

    bad = dict(variables, spectral={"conv_dim_in": {"sigma": np.ones(())}})
    with pytest.raises(KeyError, match="unknown spectral leaf"):
        flax_to_state_dict(bad)
    with pytest.raises(KeyError):
        unflatten_variables({"optimizer/x": np.zeros(1)})


def test_dense_and_factorized_agree():
    """chip_smoke.py phase 6a on the CPU: the same kernels, spectral off
    (the JAX package's tests/test_factorized_generator.py); 1e-4."""
    import chip_smoke

    out = chip_smoke.dense_and_factorized("cpu", 32)
    for i in (0, 1):
        np.testing.assert_allclose(out[True][i].numpy(),
                                   out[False][i].numpy(), **FRAME_TOL)
    assert torch.equal(out[True][2], out[False][2])


@pytest.fixture(scope="module")
def reference():
    import chip_smoke

    return chip_smoke.load_reference()


def test_port_reproduces_the_reference_file(reference):
    """The port on the CPU against the JAX outputs stored in
    torch_tools/data/reference_factorized_32.npz, at 1e-4."""
    cfg, vocab, inputs, want, flat = reference
    assert cfg.factorized_frontend and cfg.compute_dtype == "float32"
    model = from_flax(unflatten_variables(flat),
                      AG2VideoModel(cfg, vocab, device="cpu"))
    with torch.no_grad():
        got = model(*(torch.as_tensor(inputs[k]) for k in KEYS))
    for k in ("imgs_pred", "flows_pred"):
        np.testing.assert_allclose(got[k].numpy(), want[k], **FRAME_TOL)
    np.testing.assert_allclose(got["boxes_pred"].numpy(), want["boxes_pred"],
                               **BOX_TOL)
    assert (got["conf_pred"].numpy() != want["conf_pred"]).mean() <= 1e-3


def test_reference_file_is_current(reference):
    """The JAX package re-run on the stored variables and inputs gives the
    stored outputs: a file older than the JAX model fails here."""
    from torch_tools import make_reference_npz as mk

    cfg, vocab, inputs, want, flat = reference
    model, ref_cfg, _ = mk.model_and_config()
    assert cfg.to_dict() == ref_cfg.to_dict()
    args = tuple(jnp.asarray(inputs[k]) for k in KEYS)
    like = jax.eval_shape(lambda k: model.init(
        {"params": k}, *args, use_gt=True, train=False),
        jax.random.PRNGKey(0))
    got = mk.apply(model, mk.with_stored(like, flat), inputs)
    for k in ("imgs_pred", "flows_pred", "boxes_pred"):
        np.testing.assert_allclose(got[k], want[k], **BOX_TOL)
    assert (got["conf_pred"] != want["conf_pred"]).mean() <= 1e-3
