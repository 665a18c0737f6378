"""bf16 parameters with fp32 masters (`param_dtype="bfloat16"`) in the port,
and `mlp_normalization`, against the JAX package, on the CPU.

The JAX package's `with_fp32_master(optax.adam(...))` steps an fp32 master
with the gradients taken to fp32 and returns `master_new - params`, so the
live params become bf16(master_new). The port's `ScheduledAdam(master=True)`
steps fp32 master tensors with torch's Adam and copies them into the bf16
live parameters. Held here, each bound stated up front:

- the update rule against optax on a small tree over 3 steps at the
  default learning rate: the masters at rtol 1e-6 (observed <= 1.7e-7),
  and on each side live == bf16(own master) bit for bit. The two Adams
  differ in their bias corrections: torch takes 1 - beta2^t in float64,
  optax in fp32 (relative error ~6e-5 at t=1), so the masters move apart
  by ~3e-5 of an update: at lr 1e-2, 1.8e-6 of a master near 0.035;
- the port's Trainer with bf16 params, mirroring the JAX package's
  tests/test_train.py::test_bf16_params_training and
  ::test_bf16_light_resume_reinits_master (no JAX Trainer is compiled), and
  a full checkpoint that restores the masters;
- `weights.trainer_from_flax` of a bf16 TrainState: its
  `{"master", "inner"}` optax states (built with the JAX package's own
  `make_optimizers` over the port's weights, masters and moments
  perturbed) fill the Adams exactly.

The port's bf16 step (bf16 compute, fp32 and bf16 params) on the CPU is
held to the JAX package's step stored in
torch_tools/data/reference_train_bf16_64.npz, as chip_smoke.py phase 14
holds the card's, at its REF_LOSS_RTOL / REF_STATE_REL_L2.

`mlp_normalization` is read and never used by the JAX package
(models/gcn.py, layout_model.py, discriminator.py); the port accepts and
ignores it too: "batch" gives "none"'s outputs exactly in both packages.
"""

import numpy as np

import jax
import jax.numpy as jnp
import optax
import torch
from torch import nn

from ag2video_tpu.models.discriminator import \
    MultiscaleActionDiscriminator as JDisc
from ag2video_tpu.models.layout_model import Acts2LayoutModel as JLayout
from ag2video_tpu.models.meta import AG2VideoModel as JModel
from ag2video_tpu.train.state import make_optimizers as j_make_optimizers
from ag2video_tpu.train.state import with_fp32_master
from ag2video_torch.config import Config
from ag2video_torch.data.registry import Loader, get_dataset
from ag2video_torch.inference import make_inputs
from ag2video_torch.models.discriminator import MultiscaleActionDiscriminator
from ag2video_torch.models.layout_model import Acts2LayoutModel
from ag2video_torch.train import Trainer
from ag2video_torch.train import checkpoint as ckpt_lib
from ag2video_torch.train.state import ScheduledAdam
from ag2video_torch.weights import (_unmasked, flax_to_state_dict,
                                    init_params, to_flax, trainer_from_flax,
                                    transposed_keys)
from tests.test_train import tiny_config

torch.set_num_threads(2)

MASTER_RTOL = 1e-6


def _bf16_bits_equal(live: torch.Tensor, master: torch.Tensor) -> bool:
    return torch.equal(live, master.to(torch.bfloat16))


def test_master_adam_matches_optax():
    """3 Adam steps on two leaves from bf16 params and bf16 gradients."""
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (11,)}
    init = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    cfg = Config()  # the default learning rate and beta1
    live = {k: nn.Parameter(torch.from_numpy(v).to(torch.bfloat16))
            for k, v in init.items()}
    opt = ScheduledAdam(list(live.values()), cfg, master=True)

    j_opt = with_fp32_master(optax.adam(cfg.learning_rate, b1=cfg.beta1,
                                        b2=0.999))
    j_params = {k: jnp.asarray(v).astype(jnp.bfloat16)
                for k, v in init.items()}
    j_state = j_opt.init(j_params)
    for _ in range(3):
        grads = {k: rng.randn(*s).astype(np.float32)
                 for k, s in shapes.items()}
        j_grads = {k: jnp.asarray(g).astype(jnp.bfloat16)
                   for k, g in grads.items()}
        up, j_state = j_opt.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, up)
        for k, p in live.items():
            p.grad = torch.from_numpy(grads[k]).to(torch.bfloat16)
        opt.step()
        for (k, p), m in zip(live.items(), opt.masters):
            jm = np.asarray(j_state["master"][k])
            np.testing.assert_allclose(m.numpy(), jm, rtol=MASTER_RTOL,
                                       atol=0, err_msg=k)
            assert p.dtype == torch.bfloat16
            assert _bf16_bits_equal(p.detach(), m)
            np.testing.assert_array_equal(
                np.asarray(j_params[k], np.float32),
                np.asarray(j_state["master"][k].astype(jnp.bfloat16),
                           np.float32))


def _trainer(seed=0, **kw):
    cfg_j, vocab = tiny_config(param_dtype="bfloat16", seed=seed, **kw)
    cfg = Config.from_dict(cfg_j.to_dict())
    loader = Loader(get_dataset("synthetic", "train", cfg), cfg,
                    shuffle=True)
    tr = Trainer(cfg, vocab, device="cpu")
    tr.init(next(loader.epoch(0)))
    return tr, loader, cfg


def _floating(module):
    return [p for p in module.parameters() if p.is_floating_point()]


def _masters_exact(trainer):
    for opt in (trainer.state.opt_graph, trainer.state.opt_gen,
                trainer.state.opt_d):
        for p, m in zip(opt.live, opt.masters):
            assert m.dtype == torch.float32
            assert _bf16_bits_equal(p.detach(), m)


def test_bf16_params_training():
    """tests/test_train.py::test_bf16_params_training on the port: finite
    losses, params stay bf16 (norm state and buffers fp32), params move,
    and after the updates live == bf16(master) in all three Adams."""
    tr, loader, cfg = _trainer()
    graph_loader = Loader(get_dataset("synthetic", "train_graph", cfg), cfg,
                          shuffle=True)
    st = tr.state
    assert all(p.dtype == torch.bfloat16
               for m in (st.model, st.disc) for p in _floating(m))
    assert all(b.dtype != torch.bfloat16 for b in st.model.buffers())
    b0 = next(loader.epoch(0))
    p_before = _floating(st.model)[0].detach().clone()
    for _ in range(3):
        m = tr.train_step(b0)
        assert all(np.isfinite(float(v)) for v in m.values()), m
        g = tr.graph_step(next(graph_loader.epoch(0)))
        assert all(np.isfinite(float(v)) for v in g.values()), g
    assert tr.skipped_nan == 0
    assert all(p.dtype == torch.bfloat16
               for m in (st.model, st.disc) for p in _floating(m))
    assert not torch.equal(p_before, _floating(st.model)[0].detach())
    _masters_exact(tr)


def test_bf16_light_resume_reinits_master(tmp_path):
    """tests/test_train.py::test_bf16_light_resume_reinits_master on the
    port: a light resume into a differently seeded trainer restores the
    weights, its masters are fp32(restored weights), and one update stays
    near them."""
    trainer, loader, _ = _trainer(seed=0)
    b0 = next(loader.epoch(0))
    for _ in range(2):
        trainer.train_step(b0)
    out = str(tmp_path)
    t = trainer.state.step
    trainer.save_checkpoint(out, t, 0, light=True)
    saved = [p.detach().clone() for p in trainer.state.disc.parameters()]

    resumed, loader2, _ = _trainer(seed=123)
    resumed.restore_checkpoint(ckpt_lib.checkpoint_path(out, t))
    for a, b in zip(saved, resumed.state.disc.parameters()):
        assert torch.equal(a, b.detach())
    for m, p in zip(resumed.state.opt_d.masters, saved):
        assert torch.equal(m, p.float())
    resumed.train_step(next(loader2.epoch(0)))
    after = torch.cat([p.detach().float().ravel()
                       for p in resumed.state.disc.parameters()])
    before = torch.cat([p.float().ravel() for p in saved])
    assert float((after - before).abs().max()) < 0.1, \
        "post-resume update jumped away from the restored weights"


def test_bf16_full_checkpoint_keeps_masters(tmp_path):
    """A full save holds the masters (fp32, not bf16(live)); a full resume
    into a differently seeded trainer restores them exactly."""
    trainer, loader, _ = _trainer(seed=0)
    trainer.train_step(next(loader.epoch(0)))
    t = trainer.state.step
    trainer.save_checkpoint(str(tmp_path), t, 0)
    resumed, _, _ = _trainer(seed=123)
    resumed.restore_checkpoint(ckpt_lib.checkpoint_path(str(tmp_path), t))
    for name in ("opt_graph", "opt_gen", "opt_d"):
        a, b = getattr(trainer.state, name), getattr(resumed.state, name)
        assert a.count == b.count == (1 if name != "opt_graph" else 0)
        for m, n in zip(a.masters, b.masters):
            assert torch.equal(m, n)
    _masters_exact(resumed)


def test_trainer_from_flax_carries_masters():
    """A bf16 TrainState with the JAX package's masked with_fp32_master
    Adam states loads into a bf16 port Trainer: masters and moments
    exactly."""
    tr, loader, cfg = _trainer()
    vocab = tr.vocab
    batch = make_inputs(cfg, vocab, cfg.batch_size, cfg.frames_per_action,
                        seed=0)
    args = tuple(jnp.asarray(batch[k]) for k in
                 ("imgs", "objs", "triplets", "actions", "boxes"))
    jm = JModel(config=cfg, vocab=vocab)
    jd = JDisc(vocab=vocab, embedding_dim=cfg.embedding_dim,
               gconv_dim=cfg.gconv_dim,
               gconv_hidden_dim=cfg.gconv_hidden_dim, num_D=cfg.num_D,
               n_layers_D=cfg.n_layers_D, ndf=cfg.ndf, norm_D=cfg.norm_D)

    def templates(k):
        mv = jm.init({"params": k}, *args, use_gt=True, train=False)
        out = jm.apply(mv, *args, graph_only=True, train=False)
        nc = cfg.n_frames_G - 1
        dv = jd.init({"params": k}, args[0][:, nc:], args[1],
                     args[4][:, nc:],
                     {kk: v[:, nc:] for kk, v in out["actions_data"].items()},
                     train=False)
        return mv, dv

    mt, dt = jax.eval_shape(templates, jax.random.PRNGKey(0))
    st = tr.state
    mv = to_flax(mt, st.model.state_dict(), transposed_keys(st.model))
    dv = to_flax(dt, st.disc.state_dict(), transposed_keys(st.disc))
    bf16 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
    params, d_params = bf16(mv["params"]), bf16(dv["params"])
    opt_graph, opt_gen, opt_d = j_make_optimizers(cfg, params)
    rng = np.random.RandomState(0)
    noise = lambda t: jax.tree.map(
        lambda a: a + jnp.asarray(1e-3 * rng.randn(*a.shape), a.dtype), t)

    def perturbed(opt, p):
        s = opt.init(p)
        # chain(masked(master), masked(zero)): the master and moments of
        # the first element.
        inner = s[0].inner_state
        inner["master"] = noise(inner["master"])
        adam = inner["inner"][0]
        inner["inner"] = (adam._replace(count=jnp.asarray(3, jnp.int32),
                                        mu=noise(adam.mu),
                                        nu=jax.tree.map(jnp.abs,
                                                        noise(adam.nu))),
                          ) + tuple(inner["inner"][1:])
        return s

    state = dict(params=params, model_state={k: v for k, v in mv.items()
                                             if k != "params"},
                 d_params=d_params,
                 d_state={k: v for k, v in dv.items() if k != "params"},
                 opt_graph_state=perturbed(opt_graph, params),
                 opt_gen_state=perturbed(opt_gen, params),
                 opt_d_state=None, vgg_params=None,
                 step=5, epoch=0, skipped_nan=0)
    d_state = opt_d.init(d_params)
    d_state["master"] = noise(d_state["master"])
    state["opt_d_state"] = d_state
    trainer_from_flax(state, tr)
    for name, js in (("opt_graph", state["opt_graph_state"][0].inner_state),
                     ("opt_gen", state["opt_gen_state"][0].inner_state),
                     ("opt_d", state["opt_d_state"])):
        opt = getattr(st, name)
        module = st.disc if name == "opt_d" else st.model
        names = {id(p): n for n, p in module.named_parameters()}
        tk = transposed_keys(module)
        want = flax_to_state_dict({"params": _unmasked(js["master"])}, tk)
        mu = flax_to_state_dict({"params": _unmasked(js["inner"][0].mu)}, tk)
        for p, m in zip(opt.live, opt.masters):
            assert torch.equal(m, want[names[id(p)]])
            assert torch.equal(opt.state[m]["exp_avg"], mu[names[id(p)]])
        assert opt.count == int(js["inner"][0].count)
    assert st.step == 5


def test_bf16_step_holds_the_jax_reference():
    import chip_smoke

    for loss_rel, state_rel in chip_smoke.hold_train_reference(
            "cpu").values():
        assert loss_rel <= chip_smoke.REF_LOSS_RTOL
        assert state_rel <= chip_smoke.REF_STATE_REL_L2


def test_mlp_normalization_is_ignored():
    """'batch' builds the same parameters as 'none' and gives the same
    outputs: the layout model in the JAX package and in the port (holding
    the same weights), the port's discriminator on its actions, and the
    JAX discriminator's parameter tree."""
    cfg, vocab = tiny_config()
    batch = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    keys = ("objs", "triplets", "actions", "boxes")
    jargs = tuple(jnp.asarray(batch[k]) for k in keys)
    targs = tuple(torch.as_tensor(batch[k]) for k in keys)
    kw = dict(embedding_dim=cfg.embedding_dim, gconv_dim=cfg.gconv_dim,
              gconv_hidden_dim=cfg.gconv_hidden_dim, gconv_num_layers=2)
    d_kw = dict(embedding_dim=cfg.embedding_dim, gconv_dim=cfg.gconv_dim,
                gconv_hidden_dim=cfg.gconv_hidden_dim, num_D=1,
                n_layers_D=2, ndf=8)
    imgs = torch.as_tensor(batch["imgs"])
    outs, d_trees = {}, {}
    for norm in ("none", "batch"):
        jm = JLayout(vocab=vocab, mlp_normalization=norm, **kw)
        tm = init_params(Acts2LayoutModel(vocab, mlp_normalization=norm,
                                          **kw), 0)
        template = jax.eval_shape(lambda k: jm.init(k, *jargs),
                                  jax.random.PRNGKey(0))
        j_out = jm.apply(to_flax(template, tm.state_dict()), *jargs)
        with torch.no_grad():
            t_out = tm(*targs)
            td = init_params(MultiscaleActionDiscriminator(
                vocab, mlp_normalization=norm, **d_kw), 1)
            d_out = td(imgs, targs[0], targs[3], t_out[2])
        outs[norm] = (np.asarray(j_out[1]), t_out[1].numpy(),
                      torch.cat([f.reshape(-1) for fs in d_out
                                 for f in fs]).numpy())
        np.testing.assert_allclose(outs[norm][1], outs[norm][0],
                                   rtol=1e-5, atol=1e-5)
        jd = JDisc(vocab=vocab, mlp_normalization=norm, **d_kw)
        d_trees[norm] = jax.tree.map(
            lambda a: a.shape, jax.eval_shape(
                lambda k: jd.init(k, jnp.asarray(batch["imgs"]), jargs[0],
                                  jargs[3], {k2: jnp.asarray(v.numpy())
                                             for k2, v in t_out[2].items()},
                                  train=False), jax.random.PRNGKey(0)))
    for a, b in zip(outs["none"], outs["batch"]):
        np.testing.assert_array_equal(a, b)
    assert d_trees["none"] == d_trees["batch"]
