"""The port's layout rollout (ag2video_torch/models/layout_model.py) against
the JAX Acts2LayoutModel: same weights through weights.from_flax, same
inputs from a numpy seed, fp32 on the CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.models.gcn import GraphTripleConv as JGraphTripleConv
from ag2video_tpu.models.layout_model import Acts2LayoutModel as JLayout
from ag2video_tpu.models.layout_model import action_clock as j_action_clock
from ag2video_tpu.vocab import get_vocab
from ag2video_torch.models.gcn import GraphTripleConv
from ag2video_torch.models.layout_model import Acts2LayoutModel, action_clock
from ag2video_torch.weights import from_flax

torch.set_num_threads(2)

# fp32 on both sides; the rollout feeds each step's boxes to the next, so
# the rounding of T-1 steps accumulates.
TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(embedding_dim=16, gconv_dim=16, gconv_hidden_dim=32,
            gconv_num_layers=2)


def _graph_inputs(rng, vocab, B=2, F=4, O=5, E=6, A=2):
    num_attr = len(vocab["attributes"])
    objs = rng.randint(1, 3, (B, O, num_attr)).astype(np.int32)
    objs[:, -1] = 0
    triplets = np.stack(
        [rng.randint(0, O, (B, F, E)),
         rng.randint(0, len(vocab["pred_idx_to_name"]), (B, F, E)),
         rng.randint(0, O, (B, F, E))], -1).astype(np.int32)
    actions = np.concatenate(
        [rng.randint(0, O, (B, A, 1)), rng.randint(1, 3, (B, A, 1)),
         rng.randint(0, O, (B, A, 1)), rng.uniform(-0.5, 0.5, (B, A, 2)),
         rng.uniform(0, 1, (B, A, 2))], -1).astype(np.float32)
    boxes = rng.uniform(0.1, 0.5, (B, F, O, 4)).astype(np.float32)
    return objs, triplets, actions, boxes


@pytest.fixture(scope="module")
def rollout():
    rng = np.random.RandomState(0)
    vocab = get_vocab("cater")
    inputs = _graph_inputs(rng, vocab)
    jm = JLayout(vocab=vocab, **DIMS)
    variables = jm.init(jax.random.PRNGKey(0), *map(jnp.asarray, inputs))
    # Non-zero biases, so the bridge's bias mapping is exercised too.
    variables = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(-0.1, 0.1, a.shape).astype(
            np.float32), variables)
    j_out = jm.apply(variables, *map(jnp.asarray, inputs))
    tm = Acts2LayoutModel(vocab, **DIMS)
    from_flax(variables, tm)
    with torch.no_grad():
        t_out = tm(*map(torch.from_numpy, inputs))
    return j_out, t_out


def test_boxes_pred_match(rollout):
    (_, j_boxes, _), (_, t_boxes, _) = rollout
    assert tuple(t_boxes.shape) == (2, 4, 5, 4)
    np.testing.assert_allclose(t_boxes.numpy(), np.asarray(j_boxes), **TOL)


def test_obj_vecs_match(rollout):
    (j_vecs, _, _), (t_vecs, _, _) = rollout
    assert tuple(t_vecs.shape) == (2, 4, 5, 16)
    np.testing.assert_allclose(t_vecs.numpy(), np.asarray(j_vecs), **TOL)


@pytest.mark.parametrize("key", ["temporal_triplets", "relative_timesteps",
                                 "locs"])
def test_actions_data_match(rollout, key):
    (_, _, j_data), (_, _, t_data) = rollout
    np.testing.assert_allclose(t_data[key].numpy(), np.asarray(j_data[key]),
                               **TOL)


def test_action_clock_matches(rng):
    vocab = get_vocab("cater")
    _, _, actions, _ = _graph_inputs(rng, vocab, A=3)
    actions[0, 0, 3:5] = [0.7, 0.2]  # an action outside [0, 1]
    pad = vocab["action_name_to_idx"]["__padding__"]
    rel, gated = action_clock(torch.from_numpy(actions), 6, pad)
    j_rel, j_gated = j_action_clock(jnp.asarray(actions), 6, pad)
    np.testing.assert_allclose(rel.numpy(), np.asarray(j_rel), **TOL)
    np.testing.assert_array_equal(gated.numpy(), np.asarray(j_gated))


@pytest.mark.parametrize("pooling", ["avg", "sum"])
def test_graph_triple_conv_matches(rng, pooling):
    """One-hot pooling over endpoints, masked edges, avg counts clipped at 1
    (object 3 has no edges at all)."""
    B, O, E = 2, 4, 5
    obj = rng.randn(B, O, 6).astype(np.float32)
    pred = rng.randn(B, E, 3).astype(np.float32)
    edges = rng.randint(0, 3, (B, E, 2)).astype(np.int32)
    ind = rng.rand(B, E) > 0.3
    jm = JGraphTripleConv(object_output_dim=7, predicate_output_dim=5,
                          hidden_dim=8, pooling=pooling)
    args = tuple(map(jnp.asarray, (obj, pred, edges, ind)))
    variables = jm.init(jax.random.PRNGKey(1), *args)
    j_obj, j_pred = jm.apply(variables, *args)
    tm = GraphTripleConv(6, 3, 7, 5, 8, pooling)
    from_flax(variables, tm)
    with torch.no_grad():
        t_obj, t_pred = tm(*map(torch.from_numpy, (obj, pred, edges, ind)))
    np.testing.assert_allclose(t_obj.numpy(), np.asarray(j_obj), **TOL)
    np.testing.assert_allclose(t_pred.numpy(), np.asarray(j_pred), **TOL)
