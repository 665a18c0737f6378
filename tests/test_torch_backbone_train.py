"""The synthetic fidelity backbone's training half in the port against the
JAX package, on the CPU.

Held, each bound stated up front:

- `make_frame_dataset` (all three render modes) and `_area_downsample_np`
  equal to the JAX package's arrays, exactly (both are numpy over the same
  synthetic renderer);
- 3 AdamW steps on one fixed batch, its flips given (the JAX package draws
  them with `jax.random`, the port with a `torch.Generator`), from the same
  weights: the JAX side is `SyntheticEvalBackbone` + `optax.adamw` with the
  JAX `train_backbone`'s loss; the losses at rtol 1e-5 and the parameters
  at rtol 1e-5, atol 1e-6 (observed <= 5.6e-7 relative on the losses,
  <= 9.0e-7 absolute on the parameters). The steps take lr 1e-5, not the
  CLI's 2e-3, for tests/test_torch_train.py's reason: Adam's first update
  is ~lr * sign(g), so a gradient element at rounding level that flips sign
  moves its parameter by 2 * lr. At 2e-3 the third step's grid loss differs
  by 1.25e-5 relative and four conv3 kernel elements by up to 1.8e-4;
- `eval_backbone` of the committed asset on held-out frames: the JAX
  package's accuracies exactly;
- the asset format both ways: an asset the port writes holds exactly the
  weights it was given, in the JAX package's tree, and runs there; one the
  JAX package writes loads strictly in the port with exactly its weights
  (the two forwards are held to each other in tests/test_torch_eval.py);
- `scripts.train_backbone` at a tiny size (3 steps, 8 videos) into a
  temporary `--out`: the JAX CLI's JSON keys, an asset the JAX package
  loads. The committed asset is never written.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ag2video_tpu.eval import backbone as jb
from ag2video_torch.eval import backbone as tb
from ag2video_torch.scripts import train_backbone as t_cli

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
LR = 1e-5  # the parity learning rate (see the module docstring)


class _Cfg:  # the fields make_frame_dataset reads (the CLI's defaults)
    frames_per_action = 4
    number_of_objects = 7
    max_objects = 12
    max_actions = 4
    synthetic_dynamics = "linear"
    seed = 0


@pytest.mark.parametrize("mode", ["direct", "render", "image"])
def test_frame_dataset_equals_jax(mode):
    kw = {"direct": {}, "render": {"render_size": (128, 128)},
          "image": {"image_size": (96, 80)}}[mode]
    got = tb.make_frame_dataset(_Cfg, 3, "val", frames_per_video=2, seed=1,
                                **kw)
    want = jb.make_frame_dataset(_Cfg, 3, "val", frames_per_video=2, seed=1,
                                 **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    x = np.random.RandomState(0).randn(2, 128, 192, 3).astype(np.float32)
    np.testing.assert_array_equal(tb._area_downsample_np(x),
                                  jb._area_downsample_np(x))


def _batch():
    frames, pres, grids = tb.make_frame_dataset(_Cfg, 4, "train",
                                                frames_per_video=2)
    rng = np.random.RandomState(0)
    fh, fv = rng.rand(2, frames.shape[0]) < 0.5
    return frames, pres, grids, fh, fv


def test_adamw_steps_match_jax():
    frames, pres, grids, fh, fv = _batch()
    model = jb.SyntheticEvalBackbone()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    opt = optax.adamw(LR, weight_decay=1e-4)
    o = opt.init(params)

    def loss_fn(p, xb, yp, yg):  # the JAX train_backbone's
        _, pl, gl = model.apply(p, xb)
        lp = optax.sigmoid_binary_cross_entropy(pl, yp).mean()
        lg = optax.sigmoid_binary_cross_entropy(gl, yg).mean()
        return lp + lg, (lp, lg)

    xb, yp, yg = (jnp.asarray(a) for a in (frames, pres, grids))
    h, v = jnp.asarray(fh)[:, None, None, None], jnp.asarray(fv)[:, None,
                                                                  None, None]
    xb = jnp.where(h, xb[:, :, ::-1], xb)  # the JAX train_backbone's flips
    xb = jnp.where(v, xb[:, ::-1], xb)
    yg = jnp.where(h[..., 0], yg[:, :, ::-1], yg)
    yg = jnp.where(v[..., 0], yg[:, ::-1], yg)
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    tm = tb.backbone_from_params(params)
    t_opt = tb.backbone_optimizer(tm, lr=LR)
    txb, tyg = tb.flip_batch(torch.from_numpy(frames),
                             torch.from_numpy(grids), torch.from_numpy(fh),
                             torch.from_numpy(fv))
    np.testing.assert_array_equal(txb.numpy(), np.asarray(xb))
    np.testing.assert_array_equal(tyg.numpy(), np.asarray(yg))
    for _ in range(3):
        (tot, (lp, lg)), g = step(params, xb, yp, yg)
        up, o = opt.update(g, o, params)
        params = optax.apply_updates(params, up)
        t_tot, (t_lp, t_lg, _) = tb.backbone_step(
            tm, t_opt, txb, torch.from_numpy(pres), tyg)
        np.testing.assert_allclose([float(t_tot), float(t_lp), float(t_lg)],
                                   [float(tot), float(lp), float(lg)],
                                   rtol=RTOL, atol=ATOL)
    got = tb.backbone_params(tm)
    for (path, w), (_, gv) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(got)):
        np.testing.assert_allclose(gv, np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def held_out():
    return tb.make_frame_dataset(_Cfg, 8, "val", frames_per_video=2, seed=1,
                                 render_size=(128, 128))


def test_eval_backbone_on_the_asset_equals_jax(held_out):
    params, _ = tb.load_backbone(tb.DEFAULT_WEIGHTS)
    got = tb.eval_backbone(params, *held_out, device="cpu")
    assert got == jb.eval_backbone(params, *held_out)
    assert got["presence_acc"] > 0.8 and got["grid_acc"] > 0.8


def test_assets_load_in_either_package(held_out, tmp_path):
    params, meta = tb.load_backbone(tb.DEFAULT_WEIGHTS)
    x = jnp.asarray(held_out[0][:6])
    # The port writes (from a module's weights), the JAX package reads.
    port_path = tb.save_backbone(
        tb.backbone_params(tb.backbone_from_params(params)),
        str(tmp_path / "port.npz"), meta={"writer": "port"})
    j_params, j_meta = jb.load_backbone(port_path)
    assert j_meta == {"writer": "port"}
    assert jax.tree.structure(j_params) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(j_params), jax.tree.leaves(params)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    jb.SyntheticEvalBackbone().apply(j_params, x)
    # The JAX package writes, the port reads.
    jax_path = jb.save_backbone(params, str(tmp_path / "jax.npz"), meta=meta)
    t_params, t_meta = tb.load_backbone(jax_path)
    assert t_meta == meta
    loaded = tb.backbone_from_params(t_params)  # strict
    for k, v in tb.backbone_from_params(params).state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_train_backbone_cli_tiny(tmp_path, capsys):
    before = os.stat(tb.DEFAULT_WEIGHTS).st_mtime_ns
    out = str(tmp_path / "bb.npz")
    result = t_cli.main(["--steps", "3", "--batch_size", "16",
                         "--n_videos", "8", "--n_val_videos", "4",
                         "--image_size", "128,128", "--out", out,
                         "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    assert set(printed) == {"path", "acc_direct64", "acc_runres_resize64"}
    for k in ("acc_direct64", "acc_runres_resize64"):
        assert set(printed[k]) == {"presence_acc", "grid_acc"}
    assert printed["path"] == out
    j_params, meta = jb.load_backbone(out)
    assert meta["steps"] == 3 and meta["train_frames"] == 16
    assert len(meta["history"]) == 2  # steps 0 and 2
    jb.SyntheticEvalBackbone().apply(j_params, jnp.zeros((1, 64, 64, 3)))
    assert os.stat(tb.DEFAULT_WEIGHTS).st_mtime_ns == before
