"""The port's generation slice against the JAX package, fp32 on the CPU.

The slice is AG2VideoModel(test_mode=True, use_gt=False) with the dense
frontend (factorized_frontend=False): two layout rollouts, the rasterizer,
then the autoregressive flow / warp / SPADE frame loop. A small config in
the spirit of `__graft_entry__.dryrun_multichip` (ngf=4, nff=4,
n_blocks_F=1, n_downsample_F=2, gconv 16/32, 2 layers) is initialised in
JAX; its batch_stats, spectral `u`/`sigma`, BN scales and biases are
perturbed with numpy noise so the weight bridge's mapping of each is
really tested; then weights.from_flax loads it into the port.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.config import Config
from ag2video_tpu.models.meta import AG2VideoModel as JModel
from ag2video_tpu.models.normalization import NormConv as JNormConv
from ag2video_tpu.models.normalization import SNConv as JSNConv
from ag2video_tpu.vocab import get_vocab
from ag2video_torch.inference import generate, make_inputs
from ag2video_torch.models import AG2VideoModel
from ag2video_torch.models.generator import Layout2VidGenerator
from ag2video_torch.models.normalization import NormConv, SNConv
from ag2video_torch.weights import flax_to_state_dict, from_flax

torch.set_num_threads(2)

KEYS = ("imgs", "objs", "triplets", "actions", "boxes")
SMALL = dict(image_size=(32, 32), frames_per_action=3, max_objects=5,
             max_triplets=6, max_actions=2, embedding_dim=16, gconv_dim=16,
             gconv_hidden_dim=32, gconv_num_layers=2, ngf=4, nff=4,
             n_blocks_F=1, n_downsample_F=2, compute_dtype="float32",
             factorized_frontend=False)
# fp32 on both sides. Frames are sums of ~25 convs deep with values up to
# ~4 and the frame loop feeds each output into the next frame: a stated
# 1e-4 absolute / relative bound (observed ~2e-5).
FRAME_TOL = dict(rtol=1e-4, atol=1e-4)
BOX_TOL = dict(rtol=1e-5, atol=1e-5)


def _perturb(variables, rng):
    """Noise on every leaf that init leaves at a constant: BN statistics,
    BN scale/bias, conv/dense biases, spectral u and sigma."""
    out = {}
    for col, tree in variables.items():
        def f(path, a):
            a = np.asarray(a, np.float32)
            name = str(path[-1].key)
            if col == "batch_stats" and name == "var":
                return a * np.asarray(rng.uniform(0.5, 1.5, a.shape),
                                      np.float32)
            if col == "batch_stats" or col == "spectral" or \
                    name in ("bias", "scale"):
                scale = 0.5 if col == "spectral" else 0.1
                return a + np.asarray(scale * rng.randn(*a.shape),
                                      np.float32)
            return a
        out[col] = jax.tree_util.tree_map_with_path(f, tree)
    return out


@pytest.fixture(scope="module")
def slice_outputs():
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", **SMALL).derive(vocab)
    batch = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    args = tuple(jnp.asarray(batch[k]) for k in KEYS)
    jm = JModel(config=cfg, vocab=vocab)
    variables = jax.jit(lambda k: jm.init({"params": k}, *args, use_gt=True,
                                          train=False))(jax.random.PRNGKey(0))
    variables = _perturb(variables, np.random.RandomState(1))
    j_out = jax.jit(lambda v: jm.apply(v, *args, test_mode=True,
                                       use_gt=False, train=False))(variables)
    tm = AG2VideoModel(cfg, vocab)
    from_flax(variables, tm)
    with torch.no_grad():
        t_out = tm(*(torch.as_tensor(batch[k]) for k in KEYS))
    return dict(cfg=cfg, vocab=vocab, batch=batch, variables=variables,
                j=j_out, t=t_out, model=tm)


def test_imgs_pred_match(slice_outputs):
    j, t = slice_outputs["j"], slice_outputs["t"]
    assert tuple(t["imgs_pred"].shape) == (2, 3, 32, 32, 3)
    np.testing.assert_allclose(t["imgs_pred"].numpy(),
                               np.asarray(j["imgs_pred"]), **FRAME_TOL)


def test_boxes_pred_match(slice_outputs):
    j, t = slice_outputs["j"], slice_outputs["t"]
    np.testing.assert_allclose(t["boxes_pred"].numpy(),
                               np.asarray(j["boxes_pred"]), **BOX_TOL)


def test_flows_pred_match(slice_outputs):
    j, t = slice_outputs["j"], slice_outputs["t"]
    assert tuple(t["flows_pred"].shape) == (2, 3, 32, 32, 2)
    np.testing.assert_allclose(t["flows_pred"].numpy(),
                               np.asarray(j["flows_pred"]), **FRAME_TOL)


def test_conf_pred_match(slice_outputs):
    """conf is a hard threshold (err < 0.02): a pixel whose err lies within
    rounding of 0.02 may flip, so at most 0.1% of pixels may differ."""
    j, t = slice_outputs["j"], slice_outputs["t"]
    diff = t["conf_pred"].numpy() != np.asarray(j["conf_pred"])
    assert diff.mean() <= 1e-3


def test_generate_matches_model_call(slice_outputs):
    """inference.generate is the model's test path, on the model's device."""
    imgs, boxes = generate(slice_outputs["model"], slice_outputs["batch"])
    np.testing.assert_array_equal(imgs.numpy(),
                                  slice_outputs["t"]["imgs_pred"].numpy())
    np.testing.assert_array_equal(boxes.numpy(),
                                  slice_outputs["t"]["boxes_pred"].numpy())


def test_generate_pads_action_override(slice_outputs):
    """An (A, 7) override is broadcast over the batch and padded to the
    static action cap with __padding__ rows, as the JAX session does."""
    model, batch = slice_outputs["model"], slice_outputs["batch"]
    vocab = slice_outputs["vocab"]
    override = batch["actions"][0, :1]
    padded = np.zeros_like(batch["actions"])
    padded[:, :, 1] = vocab["action_name_to_idx"]["__padding__"]
    padded[:, 0] = override[0]
    _, got = generate(model, batch, actions=override, layout_only=True)
    _, want = generate(model, dict(batch, actions=padded), layout_only=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_bridge_is_strict(slice_outputs):
    """Every JAX leaf maps to a port tensor and back: the loaded state
    equals the converted variables, spectral sigma included."""
    converted = flax_to_state_dict(slice_outputs["variables"])
    state = slice_outputs["model"].state_dict()
    assert set(converted) == set(state)
    for k, v in converted.items():
        np.testing.assert_array_equal(state[k].numpy(), v.numpy())
    extra = dict(slice_outputs["variables"])
    extra["params"] = dict(extra["params"], stray={"kernel": np.zeros(2)})
    with pytest.raises(KeyError):
        from_flax(extra, AG2VideoModel(slice_outputs["cfg"],
                                       slice_outputs["vocab"]))


def test_make_inputs_matches_graft_entry(slice_outputs):
    from __graft_entry__ import _make_inputs

    cfg = slice_outputs["cfg"]
    ref = _make_inputs(cfg, slice_outputs["vocab"], B=2,
                       T=cfg.frames_per_action)
    for k in KEYS:
        np.testing.assert_array_equal(slice_outputs["batch"][k],
                                      np.asarray(ref[k]))


@pytest.mark.parametrize("H,W", [(16, 16), (15, 10)])
def test_normconv_stride2_matches(rng, H, W):
    """flax 'SAME' at stride 2 pads (0, 1) on an even size, not (1, 1);
    eval BN with scale and bias; spectral norm from the stored u."""
    x = rng.randn(2, H, W, 5).astype(np.float32)
    jm = JNormConv(8, "spectralsyncbatch", 3, strides=2)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False)
    variables = _perturb(variables, rng)
    y = jm.apply(variables, jnp.asarray(x), train=False)
    tm = NormConv(5, 8, "spectralsyncbatch", 3, stride=2)
    from_flax(variables, tm.eval())
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert tuple(out.shape) == y.shape == (2, (H + 1) // 2, (W + 1) // 2, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(y), **BOX_TOL)


@pytest.mark.parametrize("k,use_bias", [(3, True), (1, False)])
def test_snconv_matches(rng, k, use_bias):
    """flax SpectralNorm in eval: one power iteration from the stored u on
    the (-1, out) view of the HWIO kernel, then kernel / sigma."""
    x = rng.randn(2, 9, 7, 4).astype(np.float32)
    jm = JSNConv(6, k, use_bias=use_bias)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False)
    variables = _perturb(variables, rng)
    y = jm.apply(variables, jnp.asarray(x), train=False)
    tm = SNConv(4, 6, k, use_bias=use_bias)
    from_flax(variables, tm.eval())
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(y), **BOX_TOL)
    # torch's own spectral_norm skips the iteration in eval: not this.
    w = tm.conv.weight.detach()
    assert not torch.allclose(tm.spectral.normalize(w),
                              w / torch.linalg.matrix_norm(
                                  w.reshape(6, -1), ord=2))


def test_unported_modes_raise():
    vocab = get_vocab("cater")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Layout2VidGenerator(vocab, gconv_dim=16, semantic_nc=16, ngf=4,
                            nff=4, n_blocks_F=1, n_downsample_F=2,
                            factorized_frontend=True)
    gen = Layout2VidGenerator(vocab, gconv_dim=16, semantic_nc=16, ngf=4,
                              nff=4, n_blocks_F=1, n_downsample_F=2)
    x = torch.zeros(1, 2, 32, 32, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gen(x, torch.ones(1, 3, 4, dtype=torch.long), torch.zeros(1, 2, 3, 16),
            torch.zeros(1, 2, 3, 4), teacher_forced=True)
    with pytest.raises(NotImplementedError):
        gen.train()(x, torch.ones(1, 3, 4, dtype=torch.long),
                    torch.zeros(1, 2, 3, 16), torch.zeros(1, 2, 3, 4))
