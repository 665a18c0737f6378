"""The port's training step against the JAX package's Trainer, fp32 on the
CPU, from identical state.

The JAX side is the JAX package's own `Trainer` (its `create_train_state`
draws the weights); `weights.trainer_from_flax` loads that TrainState into
the port's `Trainer`, and both take the same batches (`make_inputs`, numpy
seeds). Checked: the G, D and graph losses of the first step; the G and D
gradients per leaf before the optimizer; BN running statistics and the
spectral state after one `train_step`; the losses of the second step. This
file runs the default configuration's frontend (factorized);
tests/test_torch_train_dense.py runs the same tests on the dense frontend.
The VGG loss is off in both, as in tiny_config: its L1 of random-weight
features flips sign wherever the two sides' features differ by rounding,
which moves gradients by more than the per-leaf bound below (observed
4e-3 of a leaf's largest value on identical inputs). The VGG features, the
loss and its gradient are held apart, in
tests/test_torch_norm_train.py::test_vgg_loss_matches.

Size: tests/test_train.py::tiny_config at 64x64 with 3-frame clips, so
that every batch statistic covers at least 16 values (at 32x32 the SPADE
head's 1x1 latent leaves 2 per channel, and E[x^2] - E[x]^2 in fp32 then
differs between any two implementations by more than the tolerances), and
learning_rate 1e-5: Adam's first update is ~lr * sign(g), so a gradient
element at rounding level flips and moves its parameter by 2 * lr; at the
default 1e-4 those flips move the second step's smaller losses (GAN_Img,
a mean of logits near -0.17) by up to 4e-3 relative (observed, dense).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ag2video_tpu.data.collate import Batch
from ag2video_tpu.eval import inception as j_inception
from ag2video_tpu.losses.gan import gan_loss as j_gan_loss
from ag2video_tpu.losses.gan import multiscale_gan_loss as j_multiscale
from ag2video_tpu.losses.loss_model import \
    compute_discriminator_loss as j_disc_loss
from ag2video_tpu.losses.loss_model import \
    compute_generator_loss as j_gen_loss
from ag2video_tpu.train.trainer import Trainer as JTrainer
from ag2video_torch.config import Config
from ag2video_torch.eval import inception as t_inception
from ag2video_torch.inference import make_inputs
from ag2video_torch.losses.gan import gan_loss, multiscale_gan_loss
from ag2video_torch.train import Trainer
from ag2video_torch.weights import (_unmasked, adam_state,
                                    flax_to_state_dict, trainer_from_flax)
from tests.test_torch_eval_nets import variables
from tests.test_train import tiny_config

torch.set_num_threads(2)

PARITY = dict(image_size=(64, 64), frames_per_action=3, learning_rate=1e-5)
# First step, identical state: fp32 summation order only (observed <= 7e-7).
LOSS_RTOL = 1e-4
# D, per leaf: 1e-3 of the leaf's largest JAX gradient plus 1e-6 (observed
# <= 3.5e-2 of that bound).
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
# G, as a whole: the relative L2 error of all its gradients (observed
# 2.6e-3 factorized, 4.0e-3 dense). G's train-mode BatchNorms make many of
# its leaves ill-conditioned at this size: the port's own gradients move
# by up to 0.25 of a leaf's largest value when only its batch variance is
# taken two-pass in float64 instead of flax's fp32 E[x^2] - E[x]^2, so no
# fp32 implementation, the JAX package's included, holds every G leaf to
# the per-leaf bound above (most miss it by 2-300x).
G_GRAD_REL_L2 = 1e-2
# BN running statistics and spectral u / sigma after one step (observed
# <= 3.6e-6).
STATE_ATOL = 1e-5
# Second step: the first update took rounding-level gradient elements to
# +-lr on either side (observed <= 3e-4).
STEP2_RTOL = 1e-3
# The val Inception Score: InceptionV3 in fp32 on both sides, logits
# recentred on the pass's features, where fp32 rounding is ~600x their
# spread (observed 1.7e-6 on the mean, 3.4e-5 on the std).
INCEPTION_RTOL = 1e-4


def _jbatch(b):
    return Batch(imgs=b["imgs"], objs=b["objs"], boxes=b["boxes"],
                 triplets=b["triplets"], actions=b["actions"], video_ids=[])


def _jax_grads(jt, state, cfg, batch):
    """G and D losses and gradients of the JAX trainer's G step / D step
    closures (trainer.py:150-192) at `state`, and the G step's outputs."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def g_loss_fn(params):
        out, _ = jt.model.apply(
            {"params": params, **state.model_state}, jb["imgs"], jb["objs"],
            jb["triplets"], jb["actions"], jb["boxes"], use_gt=True,
            train=True, mutable=["batch_stats", "spectral"])
        losses = j_gen_loss(cfg, jb, out,
                            jt._d_apply(state.d_params, state.d_state, False),
                            jt._vgg_features(state.vgg_params))
        return losses["total_loss"], (losses, out)

    def d_loss_fn(d_params, out):
        def d_apply(img, objs, boxes, actions_data, img2=None):
            return jt.disc.apply(
                {"params": d_params, **state.d_state}, img, objs, boxes,
                actions_data, train=True, img2=img2, mutable=["spectral"])[0]
        losses = j_disc_loss(cfg, jb, out, d_apply)
        return losses["total_img_loss"], losses

    (_, (g_losses, out)), g_grads = jax.jit(jax.value_and_grad(
        g_loss_fn, has_aux=True))(state.params)
    (_, d_losses), d_grads = jax.jit(jax.value_and_grad(
        d_loss_fn, has_aux=True))(state.d_params, out)
    return g_losses, g_grads, d_losses, d_grads, jax.device_get(out)


def _floats(m):
    return {k: float(v) for k, v in m.items()}


def run_parity(factorized: bool) -> dict:
    cfg_j, vocab = tiny_config(factorized_frontend=factorized, **PARITY)
    cfg = Config.from_dict(cfg_j.to_dict())
    B = cfg.batch_size
    # Seed 3: with seed 0 one warp coordinate of the G step lies within
    # rounding of an integer pixel, where the bilinear sample's gradient
    # jumps, and the two sides take its two values (G's relative L2 error
    # 1.1e-2).
    batch = make_inputs(cfg, vocab, B, cfg.frames_per_action, seed=3)
    graph = make_inputs(cfg, vocab, B, 4 * cfg.frames_per_action_graph,
                        seed=4)
    jt = JTrainer(cfg_j, vocab)
    jt.init(_jbatch(batch))
    state0 = jax.device_get(jt.state)
    tt = Trainer(cfg, vocab, device="cpu")
    tt.init(batch)
    trainer_from_flax(state0, tt)
    out = dict(cfg=cfg, vocab=vocab, trainer=tt)

    # Gradients before the optimizer. D's are taken on the JAX G step's
    # outputs on both sides, so they compare D alone.
    g_l, g_g, d_l, d_g, j_out = _jax_grads(jt, state0, cfg_j, batch)
    tb = tt._batch(batch)
    t_gl, _ = tt.generator_backward(tb)
    t_out = {"imgs_pred": torch.from_numpy(np.asarray(j_out["imgs_pred"])),
             "actions_data": {k: torch.from_numpy(np.asarray(v)) for k, v in
                              j_out["actions_data"].items()}}
    t_dl = tt.discriminator_backward(tb, t_out)
    out["grads"] = {
        "G": (flax_to_state_dict({"params": g_g}),
              {k: p.grad for k, p in tt.state.model.named_parameters()}),
        "D": (flax_to_state_dict({"params": d_g}),
              {k: p.grad for k, p in tt.state.disc.named_parameters()})}
    out["grad_losses"] = (_floats(g_l), _floats(t_gl), _floats(d_l),
                          _floats(t_dl))

    # Two iterations (train_step + graph_step) from the same state again:
    # the backward passes above wrote norm state.
    trainer_from_flax(state0, tt)
    steps = []
    for i in range(2):
        jm = _floats(jt.train_step(_jbatch(batch)))
        jm.update(_floats(jt.graph_step(_jbatch(graph))))
        tm = _floats(tt.train_step(batch))
        tm.update(_floats(tt.graph_step(graph)))
        steps.append((jm, tm))
        if i == 0:
            st = jax.device_get(jt.state)
            out["state1"] = (
                flax_to_state_dict({"params": st.params, **st.model_state}),
                flax_to_state_dict({"params": st.d_params, **st.d_state}),
                {k: v.clone() for k, v in tt.state.model.state_dict().items()},
                {k: v.clone() for k, v in tt.state.disc.state_dict().items()})
    out["steps"] = steps
    out["skipped"] = (int(jt.state.skipped_nan), tt.skipped_nan)
    out.update(jax_trainer=jt, jax_states=(st, jax.device_get(jt.state)),
               batch=batch, graph=graph)
    return out


@pytest.fixture(scope="module")
def parity():
    return run_parity(factorized=True)


def _close(got, want, rtol, name):
    assert np.isclose(got, want, rtol=rtol, atol=1e-7), (name, got, want)


def test_generator_losses_match(parity):
    jm, tm = parity["steps"][0]
    g_keys = [k for k in jm if k.startswith("G/")]
    assert "G/GAN_Feat" in g_keys and "G/loss_F_Warp" in g_keys
    assert set(g_keys) == {k for k in tm if k.startswith("G/")}
    for k in g_keys:
        _close(tm[k], jm[k], LOSS_RTOL, k)


def test_discriminator_losses_match(parity):
    jm, tm = parity["steps"][0]
    for k in ("D/D_img_fake", "D/D_img_real", "D/total_img_loss"):
        _close(tm[k], jm[k], LOSS_RTOL, k)


def test_graph_loss_matches(parity):
    jm, tm = parity["steps"][0]
    for k in ("Graph/bbox_pred", "Graph/total_loss"):
        _close(tm[k], jm[k], LOSS_RTOL, k)


def test_loss_values_before_the_optimizer(parity):
    """The losses that the gradients below belong to."""
    jg, tg, jd, td = parity["grad_losses"]
    for k in jg:
        _close(tg[k], jg[k], LOSS_RTOL, k)
    for k in jd:
        _close(td[k], jd[k], LOSS_RTOL, k)


def _grad_pairs(parity, which):
    """(name, JAX gradient, port gradient) of every leaf on the loss's
    path; a leaf off it (no port gradient) must have a zero JAX gradient."""
    want, got = parity["grads"][which]
    assert set(want) == set(got)
    pairs = []
    for k, w in want.items():
        if got[k] is None:
            assert float(w.abs().max()) == 0.0, k
        else:
            pairs.append((k, w, got[k]))
    assert len(pairs) > len(want) // 2
    return pairs


@pytest.mark.parametrize("which", ["G", "D"])
def test_gradients_match(parity, which):
    """Before the optimizer, from identical state: D per leaf, G as a whole
    (see G_GRAD_REL_L2)."""
    pairs = _grad_pairs(parity, which)
    if which == "D":
        for k, w, g in pairs:
            bound = GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL
            err = float((g - w).abs().max())
            assert err <= bound, (k, err, bound)
        return
    err = sum(float(((g - w) ** 2).sum()) for _, w, g in pairs) ** 0.5
    norm = sum(float((w ** 2).sum()) for _, w, _ in pairs) ** 0.5
    assert err <= G_GRAD_REL_L2 * norm, (err / norm)


def test_norm_state_after_one_step(parity):
    """BN running statistics and spectral u / sigma of G and D after one
    train_step: written once by the G step's forward (G) and by the D
    step's batched call (D), never by the frozen D of the G step."""
    j_model, j_disc, t_model, t_disc = parity["state1"]
    checked = 0
    for want, got in ((j_model, t_model), (j_disc, t_disc)):
        for k, w in want.items():
            if k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "u",
                                        "sigma"):
                err = float((got[k] - w).abs().max())
                assert err <= STATE_ATOL, (k, err)
                checked += 1
    assert checked > 40


def test_second_step_losses_match(parity):
    (j0, _), (j1, t1) = parity["steps"]
    for k in j1:
        _close(t1[k], j1[k], STEP2_RTOL, k)
    # The update is really tested: each total moved between the steps by
    # more than 10x the two sides' disagreement after it.
    for k in ("G/total_loss", "D/total_img_loss", "Graph/total_loss"):
        assert abs(t1[k] - j1[k]) < 0.1 * abs(j1[k] - j0[k]), \
            (k, j0[k], j1[k], t1[k])


def test_no_step_skipped(parity):
    assert parity["skipped"] == (0, 0)


@pytest.mark.parametrize("mode", ["hinge", "ls", "original", "w"])
@pytest.mark.parametrize("real,for_d", [(True, True), (False, True),
                                        (True, False)])
def test_gan_loss_modes_match(rng, mode, real, for_d):
    scales = [[rng.randn(2, 5, 5, 4).astype(np.float32),
               rng.randn(2, 5, 5, 1).astype(np.float32)],
              [rng.randn(2, 3, 3, 1).astype(np.float32)]]
    j = float(j_multiscale([[jnp.asarray(a) for a in s] for s in scales],
                           real, for_d, mode))
    t = float(multiscale_gan_loss([[torch.from_numpy(a) for a in s]
                                   for s in scales], real, for_d, mode))
    assert np.isclose(t, j, rtol=1e-6, atol=1e-7)
    x = scales[1][0] * 3
    assert np.isclose(float(gan_loss(torch.from_numpy(x), real, for_d, mode)),
                      float(j_gan_loss(jnp.asarray(x), real, for_d, mode)),
                      rtol=1e-6, atol=1e-7)


def test_nan_guard_keeps_state(parity):
    """A non-finite loss takes no step and restores the norm state: params,
    BN statistics, spectral state and Adam state stay as they were."""
    tt = parity["trainer"]
    cfg = parity["cfg"]
    batch = make_inputs(cfg, parity["vocab"], cfg.batch_size,
                        cfg.frames_per_action, seed=2)
    batch["imgs"][0, 1, 0, 0, 0] = np.nan
    before = ({k: v.clone() for k, v in tt.state.model.state_dict().items()},
              {k: v.clone() for k, v in tt.state.disc.state_dict().items()})
    counts = (tt.state.opt_gen.count, tt.state.opt_d.count)
    skipped = tt.skipped_nan
    m = tt.train_step(batch)
    assert not np.isfinite(float(m["G/total_loss"]))
    assert tt.skipped_nan == skipped + 1
    assert (tt.state.opt_gen.count, tt.state.opt_d.count) == counts
    for old, mod in zip(before, (tt.state.model, tt.state.disc)):
        for k, v in mod.state_dict().items():
            assert torch.equal(v, old[k]), k


def test_freeze_graph_updates_nothing(parity):
    tt = parity["trainer"]
    cfg = parity["cfg"]
    graph = make_inputs(cfg, parity["vocab"], cfg.batch_size,
                        4 * cfg.frames_per_action_graph, seed=3)
    before = {k: v.clone() for k, v in tt.state.model.state_dict().items()}
    tt.cfg = cfg.replace(freeze_graph=True)
    try:
        m = tt.graph_step(graph)
    finally:
        tt.cfg = cfg
    assert np.isfinite(float(m["Graph/total_loss"]))
    for k, v in tt.state.model.state_dict().items():
        assert torch.equal(v, before[k]), k



class BatchList:
    """A validation loader over fixed batches (check_model reads
    `epoch(0)`)."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch=0):
        return iter(self.batches)


def _moments(opt_state):
    """{port parameter name: (mu, nu)} of an optax Adam state, and its
    count."""
    adam = adam_state(opt_state)
    mu = flax_to_state_dict({"params": _unmasked(adam.mu)})
    nu = flax_to_state_dict({"params": _unmasked(adam.nu)})
    return {k: (mu[k], nu[k]) for k in mu}, int(adam.count)


def _port_moments(opt, module):
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: (st["exp_avg"].clone(), st["exp_avg_sq"].clone())
            for p, st in opt.state.items()}, opt.count


def inception_variables(trainer, val):
    """Seeded InceptionV3 variables whose logits carry the use_gt pass's
    differences between frames: a deep net of seeded weights maps every
    frame to nearly the same pool3 (spread ~2e-3 of its size), so `fc`
    is a random projection of pool3 less its mean over the pass, scaled
    to unit spread (the features that are 0 on every frame get no
    weight); elsewhere the score would be 1 on both sides."""
    v = variables(j_inception.InceptionV3(), (1, 96, 96, 3))
    net, _ = t_inception.inception_v3(v, device="cpu")
    frames = torch.cat([trainer.eval_batch(b, use_gt=True)[0].flatten(0, 1)
                        for b in val.epoch(0)])
    with torch.no_grad():
        _, pool3 = net(t_inception.resize_bilinear(frames, (299, 299)))
    f = pool3.numpy().astype(np.float64)
    sd = f.std(0)
    live = sd > 0
    inv = np.where(live, 1.0 / np.where(live, sd, 1.0), 0.0)
    k = np.random.RandomState(7).randn(2048, 1000) * inv[:, None] / \
        np.sqrt(live.sum())
    v["params"]["fc"] = {"kernel": k.astype(np.float32),
                         "bias": (-(f.mean(0) @ k)).astype(np.float32)}
    return v


OPTS = (("opt_graph", "opt_graph_state", "model"),
        ("opt_gen", "opt_gen_state", "model"),
        ("opt_d", "opt_d_state", "disc"))


@pytest.fixture(scope="module")
def carried(parity):
    """A fresh port trainer holding the JAX state after one step (weights,
    norm state, counters and the three optax Adam states); at that state
    both sides' spectral telemetry and validation IoU; then the port's
    second iteration."""
    jt = parity["jax_trainer"]
    state1, state2 = parity["jax_states"]
    cfg, vocab = parity["cfg"], parity["vocab"]
    tt = Trainer(cfg, vocab, device="cpu")
    tt.init(parity["batch"])
    trainer_from_flax(state1, tt)
    out = {"state1": state1, "state2": state2}
    out["moments1"] = {name: _port_moments(getattr(tt.state, name),
                                           getattr(tt.state, mod))
                       for name, _, mod in OPTS}
    out["counters"] = (tt.state.step, tt.state.skipped_nan)

    val = BatchList([_jbatch(make_inputs(cfg, vocab, cfg.batch_size,
                                         cfg.frames_per_action, seed=s))
                     for s in (5, 6)])
    live = jt.state
    jt.state = jax.device_put(state1)
    try:
        out["sigma"] = (jt.spectral_stats(), tt.spectral_stats())
        out["iou"] = (jt.check_model(val, use_gt=False)[0],
                      tt.check_model(val, use_gt=False)[0])
        v = inception_variables(tt, val)
        out["inception"] = (
            jt.check_model(val, use_gt=True, inception_score=j_inception.
                           InceptionScore(v))[0],
            tt.check_model(val, use_gt=True, inception_score=t_inception.
                           InceptionScore(v, device="cpu"))[0])
    finally:
        jt.state = live

    m = _floats(tt.train_step(parity["batch"]))
    m.update(_floats(tt.graph_step(parity["graph"])))
    out["step2"] = m
    out["moments2"] = {name: _port_moments(getattr(tt.state, name),
                                           getattr(tt.state, mod))
                       for name, _, mod in OPTS}
    return out


def test_trainer_from_flax_carries_the_optax_states(carried):
    """Each Adam gets exactly its own parameters' moments (optax.masked
    leaves the others' as MaskedNode), its count and the counters."""
    st = carried["state1"]
    assert carried["counters"] == (int(st.step), int(st.skipped_nan)) == \
        (1, 0)
    seen = set()
    for name, field, _ in OPTS:
        want, count = _moments(getattr(st, field))
        got, t_count = carried["moments1"][name]
        assert t_count == count == 1, name
        assert got.keys() == want.keys() and len(got) > 0, name
        for k, (mu, nu) in want.items():
            assert torch.equal(got[k][0], mu) and torch.equal(got[k][1], nu), \
                (name, k)
        assert not seen & set(got) or name == "opt_d"
        seen |= set(got) if name != "opt_d" else set()
    assert any(k.startswith("acts_to_boxes.") for k in
               carried["moments1"]["opt_graph"][0])
    assert not any(k.startswith("acts_to_boxes.") for k in
                   carried["moments1"]["opt_gen"][0])


def test_spectral_stats_match(carried):
    want, got = carried["sigma"]
    assert set(got) == set(want) and {"sigma/D_max", "sigma/G_mean"} <= \
        set(got)
    for k in want:
        assert np.isclose(got[k], want[k], rtol=1e-6, atol=0), k


def test_check_model_iou_matches(carried):
    """The use_gt=False pass's IoU triple over the same two batches."""
    want, got = carried["iou"]
    assert set(got) == set(want) == {"avg_iou", "total_iou_05",
                                     "total_iou_03"}
    assert np.isclose(got["avg_iou"], want["avg_iou"], rtol=1e-5)
    assert 0.0 < want["avg_iou"] < 1.0
    for k in ("total_iou_05", "total_iou_03"):
        assert got[k] == want[k], k


def test_check_model_inception_score_matches(carried):
    """The use_gt pass's Inception Score over the same two batches, the
    same InceptionV3 variables on both sides (pretrained: `inception`)."""
    want, got = carried["inception"]
    assert set(got) == set(want) == {"inception_mean", "inception_std"}
    for k in want:
        assert np.isclose(got[k], want[k], rtol=INCEPTION_RTOL, atol=0), \
            (k, got[k], want[k])
    assert want["inception_mean"] > 1.2 and want["inception_std"] > 0.05


def test_carried_state_takes_the_jax_second_step(carried, parity):
    """From the carried state, the second iteration's losses match the JAX
    second step's at the first step's tolerance, and the Adam moments
    after it match JAX's: they build on the carried ones (with fresh
    moments the first moment would be (1 - beta1) * g, off by the whole
    carried part)."""
    jm = parity["steps"][1][0]
    tm = carried["step2"]
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k], LOSS_RTOL, k)
    st2 = carried["state2"]
    for name, field, _ in OPTS:
        want, count = _moments(getattr(st2, field))
        got, t_count = carried["moments2"][name]
        assert t_count == count == 2, name
        for i in (0, 1):
            err = sum(float(((got[k][i] - w[i]) ** 2).sum())
                      for k, w in want.items()) ** 0.5
            norm = sum(float((w[i] ** 2).sum()) for w in want.values()) ** 0.5
            assert err <= G_GRAD_REL_L2 * norm, (name, i, err / norm)
