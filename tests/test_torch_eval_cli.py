"""The port's scoring and summary CLIs on the CPU, on a synthetic training
run at 32x32: `scripts.eval_fidelity`'s rows, its output directory
created, its checkpoint lists, and its control rows against the JAX CLI's;
and `scripts.summarize_metrics`' stdout, equal to the JAX script's."""

import json

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
