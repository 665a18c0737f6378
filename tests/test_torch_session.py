"""A JAX-trained run rendered by the port, fp32 on the CPU.

The JAX package builds a default-config (factorized) TrainState at 32x32,
its constant leaves perturbed, and saves it as a light orbax checkpoint
into a run directory; torch_tools/export_run_weights.py turns that
checkpoint into the run's `itr_<t>.npz`; the port's
`GenerationSession(run_dir, device="cpu").load()` reads it strictly. The
JAX `GenerationSession`, given the same variables, is the reference for
`generate` (use_gt False and True, an action override, layout_only),
`run_action_sweep` and `save_test_outputs`.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import torch

from ag2video_tpu.config import Config
from ag2video_tpu.data.collate import Batch as JBatch
from ag2video_tpu.inference import actions as j_actions
from ag2video_tpu.inference.generate import GenerationSession as JSession
from ag2video_tpu.train.checkpoint import save_checkpoint
from ag2video_tpu.train.state import create_train_state
from ag2video_tpu.vocab import get_vocab
from ag2video_torch.data.collate import Batch
from ag2video_torch.inference import GenerationSession, make_inputs
from tests.test_torch_generation import BOX_TOL, FRAME_TOL, _perturb
from torch_tools.export_run_weights import export

torch.set_num_threads(2)

RUN_CONFIG = dict(dataset="cater", image_size=(32, 32), frames_per_action=3,
                  max_objects=5, max_triplets=6, max_actions=2,
                  embedding_dim=8, gconv_dim=8, gconv_hidden_dim=16,
                  gconv_num_layers=2, ngf=4, nff=4, n_blocks_F=1,
                  n_downsample_F=2, num_D=1, n_layers_D=2,
                  compute_dtype="float32", no_vgg_loss=True)
VIDEO_IDS = ["vid_a", "vid_b"]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(port session, JAX session, port batch, JAX batch, run dir)."""
    vocab = get_vocab("cater")
    cfg = Config(**RUN_CONFIG).derive(vocab)
    assert cfg.factorized_frontend
    inputs = make_inputs(cfg, vocab, 2, cfg.frames_per_action, seed=0)
    state, _, _, _ = create_train_state(cfg, vocab, jax.random.PRNGKey(0),
                                        inputs)
    variables = _perturb({"params": state.params, **state.model_state},
                         np.random.RandomState(2))
    state = state.replace(
        params=variables["params"],
        model_state={k: v for k, v in variables.items() if k != "params"})
    run_dir = str(tmp_path_factory.mktemp("run"))
    save_checkpoint(run_dir, 7, 0, state, cfg, vocab, light=True)
    assert export(os.path.join(run_dir, "itr_7")) == \
        os.path.join(run_dir, "itr_7.npz")

    port = GenerationSession(run_dir, device="cpu").load()
    ref = JSession(run_dir).load_variables(variables)
    return (port, ref, Batch(**inputs, video_ids=VIDEO_IDS),
            JBatch(**inputs, video_ids=VIDEO_IDS), run_dir)


@pytest.mark.parametrize("case", ["predicted_boxes", "gt_boxes", "action",
                                  "layout_only"])
def test_session_generate_matches(sessions, case):
    port, ref, batch, jbatch, _ = sessions
    kw = {"predicted_boxes": {}, "gt_boxes": dict(use_gt=True),
          "action": dict(actions=j_actions.converge(4, 2)),
          "layout_only": dict(layout_only=True)}[case]
    imgs, boxes = port.generate(batch, **kw)
    j_imgs, j_boxes = ref.generate(jbatch, **kw)
    np.testing.assert_allclose(boxes, j_boxes, **BOX_TOL)
    if case == "layout_only":
        assert imgs is None and j_imgs is None
    else:
        assert isinstance(imgs, np.ndarray) and imgs.shape == (2, 3, 32, 32, 3)
        np.testing.assert_allclose(imgs, j_imgs, **FRAME_TOL)


def test_session_loads_the_newest_export_strictly(sessions):
    """load() takes the newest itr_*.npz; a leftover leaf fails the load."""
    port, _, _, _, run_dir = sessions
    assert port.cfg.factorized_frontend
    assert next(port.model.parameters()).device.type == "cpu"
    with np.load(os.path.join(run_dir, "itr_7.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}
    np.savez(os.path.join(run_dir, "itr_12.npz"),
             **flat, **{"params/stray/kernel": np.zeros(3, np.float32)})
    try:
        with pytest.raises(KeyError, match="stray"):
            GenerationSession(run_dir, device="cpu").load()
        # An explicit checkpoint wins over the newest one.
        GenerationSession(run_dir, checkpoint=os.path.join(
            run_dir, "itr_7.npz"), device="cpu").load()
    finally:
        os.remove(os.path.join(run_dir, "itr_12.npz"))
    with pytest.raises(RuntimeError, match="load"):
        GenerationSession(run_dir, device="cpu").generate(
            Batch(**{k: np.zeros(1) for k in ("imgs", "objs", "boxes",
                                               "triplets", "actions")},
                  video_ids=["x"]))


def test_action_sweep_writes_the_same_files(sessions, tmp_path):
    port, ref, batch, jbatch, _ = sessions
    port.run_action_sweep(batch, str(tmp_path / "port"))
    ref.run_action_sweep(jbatch, str(tmp_path / "jax"))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    assert "action_timing/converge/before/vid_a.gif" in got
    assert "gt_action/swap/vid_a.gif" in got


def test_test_outputs_match(sessions, tmp_path):
    port, ref, batch, jbatch, _ = sessions
    port.save_test_outputs(batch, str(tmp_path / "port"))
    ref.save_test_outputs(jbatch, str(tmp_path / "jax"))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want == sorted(f"test/{v}.{ext}" for v in VIDEO_IDS
                                 for ext in ("gif", "pkl"))
    for vid in VIDEO_IDS:
        pkl = {}
        for side in ("port", "jax"):
            with open(tmp_path / side / "test" / f"{vid}.pkl", "rb") as f:
                pkl[side] = pickle.load(f)
        assert pkl["port"]["box"].shape == pkl["jax"]["box"].shape
        for k in ("image", "box"):
            np.testing.assert_allclose(pkl["port"][k], pkl["jax"][k],
                                       rtol=1e-4, atol=1e-4)
