"""The port's training and generation CLIs on the CPU at 32x32: the
training CLI on a fabricated CATER tree (PNG cache written without PIL) and
its `--cache_data` pre-warmer, and its validation GIFs written without
imageio; `scripts.generate`'s pkls, equal to the session's frames, and its
GIFs, written without imageio and read back by PIL as the session's frames
in the GIF's palette (tests/test_torch_eval_cli.py: the scoring and summary
CLIs)."""

import glob
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from ag2video_torch.config import Config
from ag2video_torch.data.registry import Loader, get_dataset
from ag2video_torch.inference import GenerationSession
from ag2video_torch.utils.gif import quantize_frames
from ag2video_torch.utils.vis import plot_vid
from ag2video_torch.scripts import generate as generate_cli
from ag2video_torch.scripts import train as train_cli
from torch_tools.cater_tree import make_tree

torch.set_num_threads(2)

TINY_ARGS = ["--image_size", "32,32", "--batch_size", "2",
             "--frames_per_action", "2", "--frames_per_action_graph", "1",
             "--embedding_dim", "16", "--gconv_dim", "16",
             "--gconv_hidden_dim", "32", "--gconv_num_layers", "2",
             "--ngf", "4", "--nff", "4", "--n_blocks_F", "1",
             "--n_downsample_F", "2", "--n_layers_D", "2",
             "--compute_dtype", "float32", "--no_vgg_loss", "1",
             "--num_val_samples", "2", "--device", "cpu",
             "--num_iterations", "2", "--print_every", "1"]
# One validation round (t=0) and saves at 0 and 2.
CATER_ARGS = ["--dataset", "cater", "--max_objects", "7",
              "--max_triplets", "7", "--max_actions", "4",
              "--checkpoint_every", "2"] + TINY_ARGS
# 4 videos of 60 frames: every partition's window fits (val and test take
# 48 frames).
NFRAMES = 60
LOSSES = ("G/total_loss", "D/total_img_loss", "Graph/total_loss")


@pytest.fixture(scope="module")
def cater_env(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("cater"))
    root, splits, names = make_tree(base, n_videos=4, nframes=NFRAMES,
                                    n_objects=3, size=(32, 24), threads=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CATER_DATA_ROOT", root)
        mp.setenv("CATER_SPLITS_DIR", splits)
        mp.setenv("CATER_NFRAMES", str(NFRAMES))
        yield root


@pytest.fixture(scope="module")
def cater_run(cater_env, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cater_run"))
    # Without imageio, as on a machine that lacks it: the validation gifs
    # (4 per video, 2 videos, both passes at t=0) are written all the same.
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "imageio", None)
        trainer = train_cli.main(CATER_ARGS + ["--output_dir", out])
    for d in ("gt_val", "val"):
        gifs = glob.glob(os.path.join(out, d, "itr_0", "*.gif"))
        assert len(gifs) == 4 * 2, (d, gifs)
        for path in gifs:
            frames = read_gif(path)
            assert frames.shape[1:] == (32, 32, 3), (path, frames.shape)
    return out, trainer


def read_gif(path):
    """The frames PIL decodes from a GIF, (T, H, W, 3) uint8."""
    from PIL import Image

    frames = []
    with Image.open(path) as im:
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
    return np.stack(frames)


def read_metrics(run_dir):
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["step"], {}).update(rec)
    return out


def tree_state(root):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, files in os.walk(root) for f in files}


def test_cater_training_run_and_cache_data(cater_env, cater_run):
    out, trainer = cater_run
    assert trainer.device.type == "cpu" and trainer.state.step == 2
    assert int(trainer.state.skipped_nan) == 0
    recs = read_metrics(out)
    for t in (1, 2):
        for k in LOSSES + ("skipped_nan",):
            assert np.isfinite(recs[t][k]), (t, k)
        assert recs[t]["skipped_nan"] == 0
    assert np.isfinite(recs[0]["no_use_gt/avg_iou"])
    for name in ("itr_0", "itr_2", "run_args.json"):
        assert os.path.exists(os.path.join(out, name)), name
    cfg, vocab = Config.load_run_args(out)
    assert cfg.dataset == "cater" and vocab["attributes"]["shape"]["cube"]

    # The cache is complete: the pre-warmer returns, trains nothing and
    # touches no file.
    before, run_files = tree_state(cater_env), tree_state(out)
    assert train_cli.main(CATER_ARGS + ["--output_dir", out,
                                        "--cache_data", "1"]) is None
    assert tree_state(cater_env) == before
    assert tree_state(out) == run_files


def test_generate_cli_writes_the_session_frames(cater_run, tmp_path):
    run, _ = cater_run
    out = generate_cli.main(["--checkpoint", run, "--num_videos", "2",
                             "--save_actions", "0", "--device", "cpu",
                             "--output_dir", str(tmp_path)])
    assert out == str(tmp_path / "results_cater")
    cfg, _ = Config.load_run_args(run)
    cfg = cfg.replace(batch_size=1)
    batches = Loader(get_dataset("cater", "test", cfg), cfg, batch_size=1,
                     shuffle=False, drop_last=False).epoch(0)
    first = next(batches)
    pkls = sorted(os.listdir(os.path.join(out, "test")))
    assert len([p for p in pkls if p.endswith(".pkl")]) == 2
    assert len([p for p in pkls if p.endswith(".gif")]) == 2
    for name in pkls:
        if name.endswith(".pkl"):
            with open(os.path.join(out, "test", name), "rb") as f:
                rec = pickle.load(f)
            assert rec["image"].shape == (16, 32, 32, 3)
            assert np.isfinite(rec["image"]).all()
    session = GenerationSession(run, device="cpu").load()
    imgs, _ = session.generate(first, use_gt=True)
    with open(os.path.join(out, "test", f"{first.video_ids[0]}.pkl"),
              "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["image"], imgs[0])
    np.testing.assert_array_equal(
        read_gif(os.path.join(out, "test", f"{first.video_ids[0]}.gif")),
        quantize_frames(plot_vid(imgs[0])))


def test_generate_cli_writes_gifs_without_imageio(cater_run, tmp_path,
                                                  monkeypatch):
    run, _ = cater_run
    monkeypatch.setitem(sys.modules, "imageio", None)  # import fails
    out = generate_cli.main(["--checkpoint", run, "--num_videos", "1",
                             "--device", "cpu",
                             "--output_dir", str(tmp_path)])
    gifs = [os.path.join(d, f) for d, _, fs in os.walk(out) for f in fs
            if f.endswith(".gif")]
    # per builder (converge, swap): 3 variants and the GT clip; the test gif
    assert len(gifs) == 2 * 4 + 1
    for path in gifs:
        frames = read_gif(path)
        assert frames.shape[0] > 1 and frames.shape[1:] == (32, 32, 3)
