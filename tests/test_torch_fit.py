"""The port's training run on the CPU (port only, fp32, a 32x32 tiny
configuration): checkpoints (full, async, light, for inference) and what a
resume from each restores, `fit`'s save and validation cadence, its trace
and deadline, graph-only training, and the training CLI writing a run
directory that `GenerationSession` serves."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from ag2video_torch.config import Config
from ag2video_torch.data.registry import Loader, get_dataset
from ag2video_torch.inference import GenerationSession
from ag2video_torch.inference.generate import latest_weights
from ag2video_torch.scripts import train as train_cli
from ag2video_torch.train import Trainer
from ag2video_torch.train import checkpoint as ckpt_lib
from ag2video_torch.train.state import learning_rate
from ag2video_torch.vocab import synthetic_vocab

torch.set_num_threads(2)

# tests/test_train.py::tiny_config's sizes on the synthetic dataset.
TINY = dict(dataset="synthetic", image_size=(32, 32), batch_size=2,
            frames_per_action=2, frames_per_action_graph=1, embedding_dim=16,
            gconv_dim=16, gconv_hidden_dim=32, gconv_num_layers=2, ngf=4,
            nff=4, n_blocks_F=1, n_downsample_F=2, num_D=2, n_layers_D=2,
            dataset_size=16, number_of_objects=3, max_objects=5,
            max_triplets=6, max_actions=2, learning_rate=1e-3,
            compute_dtype="float32", no_vgg_loss=True, num_val_samples=2,
            output_dir="")


def make_cfg(**kw):
    vocab = synthetic_vocab()
    return Config(**dict(TINY, **kw)).derive(vocab), vocab


def loaders(cfg):
    return (Loader(get_dataset("synthetic", "train", cfg), cfg),
            Loader(get_dataset("synthetic", "train_graph", cfg), cfg),
            Loader(get_dataset("synthetic", "val", cfg), cfg,
                   shuffle=False, drop_last=False))


@pytest.fixture(scope="module")
def data():
    cfg, vocab = make_cfg()
    train, graph, val = loaders(cfg)
    it, git = train.epoch(0), graph.epoch(0)
    return dict(cfg=cfg, vocab=vocab, batches=[next(it) for _ in range(3)],
                graphs=[next(git) for _ in range(3)], val=val)


def trainer_for(data, cfg=None, seed=None):
    cfg = cfg or data["cfg"]
    if seed is not None:
        cfg = cfg.replace(seed=seed)
    t = Trainer(cfg, data["vocab"], device="cpu")
    t.init(data["batches"][0])
    return t


def iterate(trainer, data, i):
    m = trainer.train_step(data["batches"][i])
    m.update(trainer.graph_step(data["graphs"][i]))
    return {k: float(v) for k, v in m.items()}


def snapshot(trainer):
    """Every tensor and counter of the training state, copied."""
    st = trainer.state
    out = {f"{m}.{k}": v.clone() for m, mod in (("model", st.model),
                                                ("disc", st.disc))
           for k, v in mod.state_dict().items()}
    for name in ckpt_lib.OPTIMIZERS:
        opt = getattr(st, name)
        out[f"{name}.count"] = opt.count
        params = [p for g in opt.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            for k, v in opt.state.get(p, {}).items():
                out[f"{name}.{i}.{k}"] = v.clone()
    out.update(step=st.step, epoch=st.epoch, skipped_nan=st.skipped_nan)
    return out


def assert_state_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


def test_full_round_trip_takes_the_same_next_step(data, tmp_path):
    a = trainer_for(data)
    iterate(a, data, 0)
    iterate(a, data, 1)
    path = a.save_checkpoint(str(tmp_path), a.state.step, 3)
    assert path == ckpt_lib.checkpoint_path(str(tmp_path), 2)
    assert ckpt_lib.is_port_checkpoint(path)
    assert not ckpt_lib.is_light_checkpoint(path)
    with open(tmp_path / "counters.json") as f:
        assert json.load(f) == {"t": 2, "epoch": 3}
    b = trainer_for(data, seed=7)  # other weights, restored over
    b.restore_checkpoint(str(tmp_path))  # a run directory: its newest
    assert_state_equal(snapshot(b), snapshot(a))
    # The next iteration, bit for bit.
    assert iterate(b, data, 2) == iterate(a, data, 2)
    assert_state_equal(snapshot(b), snapshot(a))


def test_async_save_snapshots_while_training_continues(data, tmp_path,
                                                       monkeypatch):
    """The async save returns with a host copy of the state: the training
    that goes on in place before the write starts does not reach the file."""
    a = trainer_for(data)
    iterate(a, data, 0)
    want = snapshot(a)
    n = len(ckpt_lib.SAVE_TIMES)
    gate = threading.Event()
    write = ckpt_lib._write

    def held_write(*args):
        assert gate.wait(60)
        write(*args)

    monkeypatch.setattr(ckpt_lib, "_write", held_write)
    a.save_checkpoint(str(tmp_path), a.state.step, 0, block=False)
    iterate(a, data, 1)  # in place, while the write waits
    iterate(a, data, 2)
    gate.set()
    b = trainer_for(data)
    b.restore_checkpoint(str(tmp_path / "itr_1"))  # waits for the write
    assert_state_equal(snapshot(b), want)
    moved = [k for k, v in a.state.model.state_dict().items()
             if not torch.equal(v, want[f"model.{k}"])]
    assert len(moved) > 10  # the live trainer did move on
    rec = ckpt_lib.SAVE_TIMES[n]
    assert rec["block"] is False and rec["write_s"] is not None
    assert rec["bytes"] == os.path.getsize(
        tmp_path / "itr_1" / ckpt_lib.STATE_FILE)


def test_light_round_trip_resets_moments_and_schedule(data, tmp_path):
    """A light resume keeps the weights and counters and starts the three
    Adams afresh: no moments and schedule count 0, so the learning rate
    goes back to its start (niter_decay > 0 makes it depend on the
    count), as the JAX light resume's fresh optax states do."""
    cfg = data["cfg"].replace(niter=1, niter_decay=4, no_TTUR=False)
    a = trainer_for(data, cfg)
    for i in range(3):
        iterate(a, data, i)
    assert learning_rate(cfg, a.state.opt_gen.count, 0.5) < cfg.learning_rate
    full = a.save_checkpoint(str(tmp_path), 1, 0)
    light = a.save_checkpoint(str(tmp_path), 3, 0, light=True)
    assert ckpt_lib.is_light_checkpoint(light)
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == light
    assert ckpt_lib.latest_checkpoint(str(tmp_path), full_only=True) == full
    saved = ckpt_lib.load_state_file(light)
    assert set(saved) == set(ckpt_lib.LIGHT_FIELDS)

    b = trainer_for(data, cfg, seed=5)
    iterate(b, data, 0)  # moments and counts to be reset
    b.restore_checkpoint(light)
    got, want = snapshot(b), snapshot(a)
    for k in list(want):
        if k.startswith("opt_"):
            del want[k]
    assert {k: v for k, v in got.items() if not k.startswith("opt_")}.keys() \
        == want.keys()
    assert_state_equal({k: got[k] for k in want}, want)
    for name in ckpt_lib.OPTIMIZERS:
        opt = getattr(b.state, name)
        assert opt.count == 0 and len(opt.state) == 0, name
    iterate(b, data, 0)
    assert b.state.opt_gen.param_groups[0]["lr"] == learning_rate(cfg, 0)
    assert a.state.opt_gen.param_groups[0]["lr"] != learning_rate(cfg, 0)
    # A full save over the light one drops its marker.
    a.save_checkpoint(str(tmp_path), 3, 0)
    assert not ckpt_lib.is_light_checkpoint(light)


def test_restore_for_inference_keeps_the_optimizers(data, tmp_path):
    a = trainer_for(data)
    iterate(a, data, 0)
    a.state.skipped_nan = 4
    a.state.epoch = 2
    a.save_checkpoint(str(tmp_path), 1, 0)
    b = trainer_for(data, seed=3)
    opts = [getattr(b.state, n) for n in ckpt_lib.OPTIMIZERS]
    b.restore_checkpoint(str(tmp_path / "itr_1"), for_inference=True)
    want = {k: v for k, v in snapshot(a).items() if not k.startswith("opt_")}
    want.update(skipped_nan=0)
    got = snapshot(b)
    assert_state_equal({k: got[k] for k in want}, want)
    for name, opt in zip(ckpt_lib.OPTIMIZERS, opts):
        assert getattr(b.state, name) is opt and opt.count == 0


def test_restore_refuses_a_mismatched_target(data, tmp_path):
    a = trainer_for(data)
    a.save_checkpoint(str(tmp_path), 0, 0)
    wider, vocab = make_cfg(gconv_hidden_dim=64)
    b = Trainer(wider, vocab, device="cpu")
    b.init()
    with pytest.raises(RuntimeError, match="size mismatch"):
        b.restore_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        b.restore_checkpoint(str(tmp_path / "empty"))


def read_metrics(run_dir):
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["step"], {}).update(rec)
    return out


def saved_steps(first):
    return [(os.path.basename(r["path"]), r["light"], r["block"])
            for r in ckpt_lib.SAVE_TIMES[first:]]


def test_fit_cadence_resume_and_final_save(data, tmp_path):
    """Saves at t % checkpoint_every == 0 (async; every 2nd full), each
    followed by both validation passes; a full final save; on resume no
    save or validation at the resume point."""
    from ag2video_torch.utils.logging import MetricsWriter

    out = str(tmp_path)
    cfg = data["cfg"].replace(output_dir=out, checkpoint_every=2,
                              full_checkpoint_every_n=2, print_every=2)
    a = trainer_for(data, cfg)
    first = len(ckpt_lib.SAVE_TIMES)
    writer = MetricsWriter(out)
    last = a.fit(*loaders(cfg), num_iterations=5, metrics_writer=writer,
                 timing=True)
    assert saved_steps(first) == [("itr_0", False, False),
                                  ("itr_2", True, False),
                                  ("itr_4", False, False),
                                  ("itr_5", False, True)]
    assert np.isfinite(last["G/total_loss"])
    assert a.state.step == 5
    recs = read_metrics(out)
    for t in (0, 2, 4):
        for k in ("no_use_gt/avg_iou", "no_use_gt/total_iou_05",
                  "use_gt/fidelity_fid", "use_gt/fidelity_presence_acc"):
            assert np.isfinite(recs[t][k]), (t, k)
    for t in (2, 4):
        for k in ("G/total_loss", "D/total_img_loss", "Graph/total_loss",
                  "sigma/D_max", "skipped_nan", "step_ms_p50"):
            assert np.isfinite(recs[t][k]), (t, k)
    assert "use_gt/avg_iou" not in recs[0]  # the IoU comes from no_use_gt

    b = trainer_for(data, cfg)
    b.restore_checkpoint(out)
    assert b.state.step == 5
    first = len(ckpt_lib.SAVE_TIMES)
    b.fit(*loaders(cfg), num_iterations=7, metrics_writer=writer)
    writer.close()
    assert saved_steps(first) == [("itr_6", True, False),
                                  ("itr_7", False, True)]
    recs = read_metrics(out)
    assert "no_use_gt/avg_iou" in recs[6]
    # Re-entering after the end runs nothing and saves nothing.
    first = len(ckpt_lib.SAVE_TIMES)
    b.fit(*loaders(cfg), num_iterations=7)
    assert saved_steps(first) == [] and b.state.step == 7


def test_fit_profile_steps_writes_a_trace(data, tmp_path):
    cfg = data["cfg"].replace(output_dir=str(tmp_path), profile_steps=1,
                              checkpoint_every=100)
    a = trainer_for(data, cfg)
    a.fit(*loaders(cfg)[:2], num_iterations=4)
    traces = os.listdir(tmp_path / "profile")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "profile" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("train_step" in e.get("name", "") or "aten::" in
               e.get("name", "") for e in events)


@pytest.mark.parametrize("with_output_dir", [False, True],
                         ids=["no_output_dir", "output_dir"])
def test_fit_wall_deadline_exits_75(data, tmp_path, with_output_dir):
    """Past the deadline the loop stops with rc 75 at the next log step,
    after a full save when there is an output_dir, and without an
    output_dir too (the JAX loop ignores the deadline then)."""
    out = str(tmp_path) if with_output_dir else ""
    cfg = data["cfg"].replace(output_dir=out, wall_deadline=1.0,
                              print_every=1, checkpoint_every=100)
    a = trainer_for(data, cfg)
    first = len(ckpt_lib.SAVE_TIMES)
    with pytest.raises(SystemExit) as e:
        a.fit(*loaders(cfg)[:2], num_iterations=5)
    assert e.value.code == 75
    assert a.state.step == 1
    want = [("itr_0", False, False), ("itr_1", False, True)] \
        if with_output_dir else []
    assert saved_steps(first) == want


def test_fit_graph_only_counts_its_own_steps(data):
    cfg = data["cfg"].replace(graph_only=True)
    a = trainer_for(data, cfg)
    before = {k: v.clone() for k, v in a.state.disc.state_dict().items()}
    last = a.fit(None, loaders(cfg)[1], num_iterations=3, log_every=1)
    assert a.state.step == 3
    assert set(last) == {"Graph/bbox_pred", "Graph/total_loss"}
    assert a.state.opt_graph.count == 3 and a.state.opt_gen.count == 0
    for k, v in a.state.disc.state_dict().items():
        assert torch.equal(v, before[k]), k


CLI_ARGS = ["--dataset", "synthetic", "--image_size", "32,32",
            "--batch_size", "2", "--frames_per_action", "2",
            "--frames_per_action_graph", "1", "--embedding_dim", "16",
            "--gconv_dim", "16", "--gconv_hidden_dim", "32",
            "--gconv_num_layers", "2", "--ngf", "4", "--nff", "4",
            "--n_blocks_F", "1", "--n_downsample_F", "2", "--n_layers_D", "2",
            "--dataset_size", "16", "--number_of_objects", "3",
            "--max_objects", "5", "--max_triplets", "6", "--max_actions", "2",
            "--compute_dtype", "float32", "--no_vgg_loss", "1",
            "--num_val_samples", "2", "--checkpoint_every", "2",
            "--print_every", "2", "--timing", "1"]


def test_cli_run_resumes_and_serves(data, tmp_path):
    out = str(tmp_path / "run")
    args = CLI_ARGS + ["--output_dir", out, "--device", "cpu"]
    trainer = train_cli.main(args + ["--num_iterations", "3"])
    assert trainer.device.type == "cpu" and trainer.state.step == 3
    files = os.listdir(out)
    for name in ("run_args.json", "counters.json", "metrics.jsonl",
                 "itr_0", "itr_2", "itr_3"):
        assert name in files, name
    assert any(f.startswith("events.out.tfevents.") for f in files)
    cfg, _ = Config.load_run_args(out)
    assert cfg.image_size == (32, 32) and cfg.num_iterations == 3

    # --restore_checkpoint 1: no such --checkpoint_name, so the newest.
    resumed = train_cli.main(args + ["--num_iterations", "4",
                                     "--restore_checkpoint", "1"])
    assert resumed.state.step == 4
    assert "itr_4" in os.listdir(out)

    if not torch.cuda.is_available():  # the card by default, or raise
        with pytest.raises(RuntimeError, match="CUDA"):
            GenerationSession(out)
    session = GenerationSession(out, device="cpu").load()
    batch = next(data["val"].epoch(0))
    imgs, boxes = session.generate(batch)
    want_imgs, want_boxes, _ = resumed.eval_batch(batch, use_gt=False)
    np.testing.assert_array_equal(imgs, want_imgs.numpy())
    np.testing.assert_array_equal(np.clip(boxes, 0.0, 1.0),
                                  want_boxes.numpy())


def test_cli_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(CLI_ARGS + ["--output_dir", str(tmp_path),
                                   "--num_iterations", "1"])


def test_latest_weights_reads_the_port_checkpoints(data, tmp_path):
    """The session's newest weights: port itr_<t>/ checkpoints and exported
    itr_<t>.npz files by t, the checkpoint first at one t; a directory
    that is not a port checkpoint (a JAX run's orbax itr_<t>/) is skipped."""
    a = trainer_for(data)
    run = str(tmp_path)
    a.save_checkpoint(run, 5, 0)
    (tmp_path / "itr_5.npz").write_bytes(b"")
    (tmp_path / "itr_3.npz").write_bytes(b"")
    assert latest_weights(run) == os.path.join(run, "itr_5")
    os.makedirs(tmp_path / "itr_9")  # orbax-like: no train_state.pt
    assert latest_weights(run) == os.path.join(run, "itr_5")
    (tmp_path / "itr_7.npz").write_bytes(b"")
    assert latest_weights(run) == os.path.join(run, "itr_7.npz")
    assert ckpt_lib.latest_checkpoint(run) == os.path.join(run, "itr_5")


def test_val_inception_is_skipped_without_its_asset(data, tmp_path,
                                                    monkeypatch, caplog):
    """With no Inception asset (this repository has none) the val pass
    skips the Inception Score with the JAX warning; with one it builds an
    InceptionScore from it (pretrained, not random_init) on the trainer's
    device; an injected scorer is kept. The fidelity scorer is built from
    the committed backbone either way."""
    from ag2video_torch.eval.backbone import FidelityScore
    from ag2video_torch.eval.inception import InceptionScore
    from ag2video_torch.scripts.port_torch_weights import port_inception
    from ag2video_torch.train import trainer as trainer_mod
    from torch_tools.eval_assets import state_dicts

    cfg = data["cfg"].replace(val_inception=True)
    a = trainer_for(data, cfg)
    asset = str(tmp_path / "inception_v3.npz")
    monkeypatch.setattr(trainer_mod, "INCEPTION_WEIGHTS", asset)
    with caplog.at_level("WARNING"):
        inception, fidelity = a._scorers(data["val"])
    assert inception is None and isinstance(fidelity, FidelityScore)
    assert "SKIPPING the val Inception Score" in caplog.text
    assert a._scorers(None) == (None, None)
    port_inception(state_dicts("inception")[0], asset)
    inception, fidelity = a._scorers(data["val"])
    assert isinstance(inception, InceptionScore)
    assert not inception.random_init and inception.device.type == "cpu"
    assert isinstance(fidelity, FidelityScore)
    injected = object()
    assert a._scorers(data["val"], inception_score=injected)[0] is injected
    a.cfg = cfg.replace(val_inception=False, val_fidelity=False)
    assert a._scorers(data["val"]) == (None, None)
