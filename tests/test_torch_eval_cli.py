"""The port's scoring and summary CLIs on the CPU, on a synthetic training
run at 32x32: `scripts.eval_fidelity`'s rows, its output directory
created, its checkpoint lists, and its control rows against the JAX CLI's;
and `scripts.summarize_metrics`' stdout, equal to the JAX script's."""

import json
import os

import numpy as np
import pytest
import torch

from ag2video_torch.config import Config
from ag2video_torch.data.registry import Loader, get_dataset
from ag2video_torch.scripts import eval_fidelity as t_eval
from ag2video_torch.scripts import summarize_metrics as t_summarize
from ag2video_torch.scripts import train as train_cli

from tests.test_torch_cli import TINY_ARGS

torch.set_num_threads(2)

# Saves at 0, 1 (light) and 2.
SYNTH_ARGS = ["--dataset", "synthetic", "--dataset_size", "8",
              "--number_of_objects", "3", "--max_objects", "5",
              "--max_triplets", "6", "--max_actions", "2",
              "--checkpoint_every", "1"] + TINY_ARGS


@pytest.fixture(scope="module")
def synth_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synth_run"))
    train_cli.main(SYNTH_ARGS + ["--output_dir", out])
    return out


def test_eval_fidelity_cli(synth_run, tmp_path):
    out = tmp_path / "new_dir" / "fidelity.json"
    results = t_eval.main(["--run_dir", synth_run, "--checkpoints", "all",
                           "--num_samples", "4", "--batch_size", "2",
                           "--device", "cpu", "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(results))
    assert [r["step"] for r in results["checkpoints"]] == [0, 1, 2]
    for row in results["checkpoints"]:
        assert np.isfinite(row["fidelity_fid"])
        assert 0 <= row["fidelity_presence_acc"] <= 1
    rr, nz = (results["controls"][k] for k in ("real_vs_real",
                                               "noise_vs_real"))
    assert rr["fidelity_fid"] < nz["fidelity_fid"]
    assert [t for t, _ in t_eval.list_checkpoints(synth_run, "full")] == \
        [0, 2]
    assert [t for t, _ in t_eval.list_checkpoints(synth_run, "latest")] == \
        [2]


# The JAX and the torch backbone's fp32 features differ at rounding level,
# and FID's matrix square root of a rank-deficient product amplifies that
# (4e-6 relative on these 8 clips).
CONTROL_FID_RTOL = 1e-4


def test_control_rows_match_the_jax_cli(synth_run):
    from ag2video_tpu.config import Config as JConfig
    from ag2video_tpu.data import registry as j_registry
    from ag2video_tpu.eval.backbone import FidelityScore as JFidelity
    from ag2video_torch.eval.backbone import (DEFAULT_WEIGHTS, FidelityScore,
                                              load_backbone)
    from scripts import eval_fidelity as j_eval

    params, _ = load_backbone(DEFAULT_WEIGHTS)
    cfg, _ = Config.load_run_args(synth_run)
    jcfg, _ = JConfig.load_run_args(synth_run)
    got = t_eval.control_rows(
        cfg, Loader(get_dataset("synthetic", "val", cfg), cfg,
                    shuffle=False, drop_last=False),
        FidelityScore(params, device="cpu"), 8)
    want = j_eval.control_rows(
        jcfg, j_registry.Loader(j_registry.get_dataset("synthetic", "val",
                                                       jcfg), jcfg,
                                shuffle=False, drop_last=False),
        JFidelity(params), 8)
    for row in ("real_vs_real", "noise_vs_real"):
        assert sorted(got[row]) == sorted(want[row])
        assert got[row]["fidelity_presence_acc"] == \
            want[row]["fidelity_presence_acc"]
        np.testing.assert_allclose(got[row]["fidelity_fid"],
                                   want[row]["fidelity_fid"],
                                   rtol=CONTROL_FID_RTOL)


@pytest.mark.parametrize("flags", [[], ["--all"],
                                   ["--keys", "G/total_loss", "D/D_img_fake",
                                    "no_such/key"]],
                         ids=["default", "all", "keys"])
def test_summarize_metrics_prints_what_the_jax_script_prints(
        synth_run, capsys, flags):
    from scripts import summarize_metrics as j_summarize

    got = t_summarize.main([synth_run] + flags)
    got_out = capsys.readouterr().out
    want = j_summarize.main([synth_run] + flags)
    assert got_out == capsys.readouterr().out
    assert got == want and got
    if not flags:
        assert {"G/total_loss", "D/total_img_loss",
                "Graph/total_loss"} <= set(got)


# scripts.eval_iou: the rule baseline against the JAX package's (fp32 box
# arithmetic in another op order; observed: equal), and the CLI's three
# modes. A JAX session cannot read the port's run, so the JAX CLI's sweeps
# run on the port's session (its `generate` is what both CLIs call, and
# the JAX sweeps' `load(batch)` is a no-op here): every key and value the
# port's CLI prints must be the JAX sweeps' on the same rollouts, and in
# the plain mode the rule rows must be what the JAX package's
# rule_based_boxes + iou_stats give on the same batches.
RULE_ATOL = 1e-6


def _val_batches(run_dir, n=2, batch_size=2):
    cfg, _ = Config.load_run_args(run_dir)
    loader = Loader(get_dataset("synthetic", "val", cfg), cfg,
                    batch_size=batch_size, shuffle=False, drop_last=False)
    out = []
    for b in loader.epoch(0):
        out.append(b)
        if len(out) == n:
            return cfg, out


def test_rule_based_boxes_matches_jax(synth_run):
    import jax.numpy as jnp

    from ag2video_tpu.models.rule_baseline import rule_based_boxes as j_rule
    from ag2video_torch.inference import make_inputs
    from ag2video_torch.models.rule_baseline import rule_based_boxes

    cfg, batches = _val_batches(synth_run)
    vocab = Config.load_run_args(synth_run)[1]
    arrays = [(b.objs, b.triplets, b.actions, b.boxes) for b in batches]
    rnd = make_inputs(cfg, vocab, 3, 5, seed=2)
    rnd["actions"][..., 1] = vocab["action_name_to_idx"]["_slide"]
    arrays.append(tuple(rnd[k] for k in ("objs", "triplets", "actions",
                                          "boxes")))
    for objs, trip, acts, boxes in arrays:
        want = np.asarray(j_rule(*(jnp.asarray(a) for a in
                                   (objs, trip, acts, boxes)), vocab))
        got = rule_based_boxes(*(torch.as_tensor(np.asarray(a)) for a in
                                 (objs, trip, acts, boxes)), vocab)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RULE_ATOL)
        assert np.abs(want[:, 1:] - want[:, :1]).max() > 0  # boxes move


def test_eval_iou_helpers_equal_jax(synth_run):
    from ag2video_torch.scripts import eval_iou as t_iou
    from scripts import eval_iou as j_iou

    _, batches = _val_batches(synth_run)
    vocab = Config.load_run_args(synth_run)[1]
    for b in batches:
        got, got_n = t_iou.composition_variants(b, vocab)
        want, want_n = j_iou.composition_variants(b, vocab)
        assert got_n == want_n and list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        for f in (2, 4):
            g, w = t_iou.extended_batch(b, f), j_iou.extended_batch(b, f)
            for k in ("imgs", "boxes", "triplets", "objs", "actions"):
                np.testing.assert_array_equal(getattr(g, k), getattr(w, k))


class _PortSession:
    """The port's session under the JAX sweeps' interface."""

    def __init__(self, sess):
        self.sess, self.vocab = sess, sess.vocab

    def load(self, batch):
        pass

    def generate(self, *args, **kwargs):
        return self.sess.generate(*args, **kwargs)


def _close_tree(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                   err_msg=path)
    elif isinstance(want, float):
        assert np.isfinite(got) and abs(got - want) <= 1e-4, path
    else:
        assert got == want, path


@pytest.mark.parametrize("sweep", [None, "composition", "horizon"])
def test_eval_iou_cli(synth_run, sweep, capsys):
    import jax.numpy as jnp

    from ag2video_tpu.models.rule_baseline import rule_based_boxes as j_rule
    from ag2video_tpu.ops.metrics import iou_stats as j_iou_stats
    from ag2video_torch.inference import GenerationSession
    from ag2video_torch.scripts import eval_iou as t_iou
    from scripts import eval_iou as j_iou

    argv = ["--checkpoint", synth_run, "--num_samples", "4",
            "--batch_size", "2", "--device", "cpu"]
    got = t_iou.main(argv + (["--sweep", sweep] if sweep else []))
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
    cfg, batches = _val_batches(synth_run)
    sess = GenerationSession(synth_run, overrides={"batch_size": 2},
                             device="cpu").load()
    loader = Loader(get_dataset("synthetic", "val", sess.cfg), sess.cfg,
                    batch_size=2, shuffle=False, drop_last=False)
    if sweep:
        run = (j_iou.run_composition_sweep if sweep == "composition"
               else j_iou.run_horizon_sweep)
        want = run(_PortSession(sess), loader, 4)
        contract = got.pop("eval_contract")
        assert contract == {"partition": "val", "num_samples": 4,
                            "batch_size": 2,
                            "checkpoint": os.path.abspath(synth_run)}
        _close_tree(got, want)
        return
    assert sorted(got) == ["model", "n_videos", "rule"]
    assert got["n_videos"] == 4
    tot = np.zeros(4)
    for b in batches:
        rule = j_rule(*(jnp.asarray(a) for a in (b.objs, b.triplets,
                                                 b.actions, b.boxes)),
                      sess.vocab)
        mask = np.broadcast_to((b.objs[..., 0] != 0)[:, None, :],
                               b.boxes[:, 1:].shape[:-1])
        tot += np.array([float(s) for s in j_iou_stats(
            rule[:, 1:], jnp.asarray(b.boxes[:, 1:]), jnp.asarray(mask))])
    want = {"avg_iou": tot[0] / tot[3], "iou@0.5": tot[1] / tot[3],
            "iou@0.3": tot[2] / tot[3]}
    assert sorted(got["rule"]) == sorted(want)
    for k, v in want.items():
        assert abs(got["rule"][k] - v) <= 1e-6, k
    for k, v in got["model"].items():
        assert np.isfinite(v) and 0 <= v <= 1, k
