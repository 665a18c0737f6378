"""The flow net's transposed-conv decoder (`flow_deconv`) in the port against
the JAX package, fp32 on the CPU.

flax's `ConvTranspose` (padding 'SAME', stride 2, k=3) dilates its input,
pads it lax's way ((2, 1) for k=3, s=2) and cross-correlates with its HWIO
kernel as stored; torch's `conv_transpose2d` flips the kernel and takes it
as (in, out, kh, kw). The port keeps the flipped kernel in torch's layout
(weights.py maps it) and crops one `conv_transpose2d` to flax's window
(layers.conv_transpose2d_nhwc); its spectral norm views the kernel in
flax's layout. Held here: the transposed NormConv and
FlowsGenerator(flow_deconv=True) of both frontends (the factorized one's
has no `down_0`) at an even and an odd size, from JAX's init carried over
(weights.from_flax) and from the port's seeded init carried back
(weights.to_flax), in eval and train mode; the seeded init's fan-in;
one AG2VideoModel generation at 32x32; and the port's Trainer taking a
step with `flow_deconv` and with `mlp_normalization="batch"` (read and
ignored, as the JAX package ignores it).

Bounds, stated up front: one fp32 module on both sides, rel-L2 <= 1e-5
(observed <= 4.0e-7 for the flow nets, <= 4.6e-7 for the NormConv); the
whole model's frames and flows at tests/test_torch_generation.py's
FRAME_TOL (observed 1.2e-5 / 9.5e-7 absolute), from the port's seeded
weights.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.config import Config
from ag2video_tpu.models.flow import FlowsGenerator as JFlows
from ag2video_tpu.models.meta import AG2VideoModel as JModel
from ag2video_tpu.models.normalization import NormConv as JNormConv
from ag2video_tpu.vocab import get_vocab
from ag2video_torch.inference import make_inputs
from ag2video_torch.models import AG2VideoModel
from ag2video_torch.models.flow import FlowsGenerator
from ag2video_torch.models.layers import ConvTranspose
from ag2video_torch.models.normalization import NormConv
from ag2video_torch.weights import (flax_to_state_dict, from_flax,
                                    init_params, to_flax, transposed_keys)
from tests.test_torch_generation import FRAME_TOL, KEYS, SMALL, _perturb

torch.set_num_threads(2)

REL_L2 = 1e-5
# Input sizes: the outputs are 32x32 and 24x40 (the decoder doubles).
SIZES = [(16, 16), (12, 20)]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _variables(jm, tm, x, seeded, rng, **kw):
    """The same variables for both modules: JAX's init (seeded=False) or the
    port's seeded init mapped into JAX's tree (seeded=True); state
    perturbed; loaded into the port."""
    if seeded:
        template = jax.eval_shape(
            lambda k: jm.init(k, jnp.asarray(x), **kw),
            jax.random.PRNGKey(0))
        init_params(tm, 3)
        variables = to_flax(template, tm.state_dict(), transposed_keys(tm))
    else:
        variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), **kw)
    variables = _perturb(variables, rng)
    from_flax(variables, tm)
    return variables


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("norm", ["spectralsyncbatch", "spectral",
                                  "spectralinstance"])
def test_transposed_normconv_matches(rng, norm, seeded, size):
    """Output (2x the input), and in train mode the state written."""
    x = rng.randn(2, *size, 6).astype(np.float32)
    jm = JNormConv(5, norm, 3, strides=2, transpose=True)
    tm = NormConv(6, 5, norm, 3, stride=2, transpose=True)
    variables = _variables(jm, tm, x, seeded, rng, train=False)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 2 * size[0], 2 * size[1], 5)
    assert _rel_l2(got, want) <= REL_L2
    out_j, new_j = jm.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats", "spectral"])
    out_t = tm(torch.from_numpy(x), train=True).detach().numpy()
    assert _rel_l2(out_t, out_j) <= REL_L2
    state_j = flax_to_state_dict(dict(new_j))
    for k, v in state_j.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("size", [(32, 32), (24, 40)])
@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("skip_first", [False, True])
def test_flow_deconv_net_matches(rng, skip_first, seeded, size):
    """FlowsGenerator(flow_deconv=True): the dense frontend's net and the
    factorized one's (skip_first), weight and flow."""
    c_in = 4 if skip_first else 7
    x = rng.randn(2, *size, c_in).astype(np.float32)
    jm = JFlows(nff=4, n_blocks_F=1, n_downsample_F=2, flow_deconv=True,
                skip_first=skip_first)
    tm = FlowsGenerator(c_in, nff=4, n_blocks_F=1, n_downsample_F=2,
                        flow_deconv=True, skip_first=skip_first)
    assert len(transposed_keys(tm)) == 2
    variables = _variables(jm, tm, x, seeded, rng, train=False)
    w_j, f_j = jm.apply(variables, jnp.asarray(x), train=False)
    w_t, f_t = tm(torch.from_numpy(x))
    assert _rel_l2(f_t.detach().numpy(), f_j) <= REL_L2
    assert _rel_l2(w_t.detach().numpy(), w_j) <= REL_L2


def test_seeded_init_keeps_flax_fan_in():
    """lecun-normal over flax's (kh, kw, in, out) kernel: std
    sqrt(1 / (9 * in)), whatever the port's layout."""
    m = ConvTranspose(96, 8, 3)
    init_params(m, 0)
    assert tuple(m.weight.shape) == (96, 8, 3, 3)
    std = float(m.weight.detach().std())
    assert abs(std / np.sqrt(1 / (9 * 96)) - 1) < 0.05


def test_flow_deconv_generation_matches():
    """AG2VideoModel(test_mode=True, use_gt=False) with flow_deconv at
    32x32, both frontends' switch at its default (factorized)."""
    vocab = get_vocab("cater")
    cfg = Config(dataset="cater", flow_deconv=True,
                 **dict(SMALL, factorized_frontend=True)).derive(vocab)
    batch = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    args = tuple(jnp.asarray(batch[k]) for k in KEYS)
    jm = JModel(config=cfg, vocab=vocab)
    tm = AG2VideoModel(cfg, vocab, device="cpu")  # seeded weights
    assert len(transposed_keys(tm)) == 2
    template = jax.eval_shape(lambda k: jm.init(
        {"params": k}, *args, use_gt=True, train=False),
        jax.random.PRNGKey(0))
    variables = _perturb(to_flax(template, tm.state_dict(),
                                 transposed_keys(tm)),
                         np.random.RandomState(1))
    from_flax(variables, tm)
    j_out = jax.jit(lambda v: jm.apply(v, *args, test_mode=True,
                                       use_gt=False, train=False))(variables)
    with torch.no_grad():
        t_out = tm(*(torch.as_tensor(batch[k]) for k in KEYS))
    np.testing.assert_allclose(t_out["imgs_pred"].numpy(),
                               np.asarray(j_out["imgs_pred"]), **FRAME_TOL)
    np.testing.assert_allclose(t_out["flows_pred"].numpy(),
                               np.asarray(j_out["flows_pred"]), **FRAME_TOL)


@pytest.mark.parametrize("mode", [dict(flow_deconv=True),
                                  dict(mlp_normalization="batch")],
                         ids=["flow_deconv", "mlp_normalization"])
def test_config_mode_trains(mode):
    """The port's Trainer takes a train_step and a graph_step in the mode
    at tests/test_train.py::tiny_config: finite losses, no skipped step;
    with flow_deconv the decoder's transposed kernels move."""
    from ag2video_torch.config import Config as TConfig
    from ag2video_torch.data.registry import Loader, get_dataset
    from ag2video_torch.train import Trainer
    from tests.test_train import tiny_config

    cfg_j, vocab = tiny_config(**mode)
    cfg = TConfig.from_dict(cfg_j.to_dict())
    batch = next(Loader(get_dataset("synthetic", "train", cfg), cfg,
                        shuffle=False).epoch(0))
    graph = next(Loader(get_dataset("synthetic", "train_graph", cfg), cfg,
                        shuffle=False).epoch(0))
    tr = Trainer(cfg, vocab, device="cpu")
    tr.init(batch)
    model = tr.state.model
    keys = sorted(transposed_keys(model))
    assert len(keys) == (2 if "flow_deconv" in mode else 0)
    before = {k: model.state_dict()[k].clone() for k in keys}
    m = tr.train_step(batch)
    m.update(tr.graph_step(graph))
    assert all(np.isfinite(float(v)) for v in m.values()), m
    assert tr.skipped_nan == 0
    for k in keys:
        assert not torch.equal(model.state_dict()[k], before[k]), k
