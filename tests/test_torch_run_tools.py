"""The port's twins of the JAX package's run tools against the originals,
on the CPU: torch_tools/sigma_audit.py against tools/sigma_audit.py's
`audit_tree` on the same weights (a small port trainer after 2 steps, its
variables carried into flax trees by `weights.to_flax`), and
torch_tools/jsonl_to_tfevents.py against tools/jsonl_to_tfevents.py on one
metrics.jsonl (the records, the edge values, the skip and --force)."""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ag2video_tpu.models.discriminator import \
    MultiscaleActionDiscriminator as JDisc
from ag2video_tpu.models.meta import AG2VideoModel as JModel
from ag2video_torch.config import Config
from ag2video_torch.inference import make_inputs
from ag2video_torch.train import Trainer
from ag2video_torch.weights import to_flax, transposed_keys
from tests.test_tfevents import _decode_event, _read_records
from tests.test_train import tiny_config
from tools import jsonl_to_tfevents as j_tfevents
from tools.sigma_audit import audit_tree
from torch_tools import jsonl_to_tfevents as t_tfevents
from torch_tools import sigma_audit

torch.set_num_threads(2)

# sigma_true: float64 SVD here, float32 in the JAX tool.
SIGMA_RTOL = 1e-5


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A small port trainer (flow_deconv: a transposed kernel's view too)
    after 2 steps, saved with its run_args.json -> (trainer, its flax
    variables (model, disc), run directory)."""
    jcfg, vocab = tiny_config(flow_deconv=True)
    cfg = Config.from_dict(jcfg.to_dict())
    run = str(tmp_path_factory.mktemp("audit_run"))
    cfg = cfg.replace(output_dir=run)
    trainer = Trainer(cfg, vocab, device="cpu")
    trainer.init()
    for seed in range(2):
        trainer.train_step(make_inputs(cfg, vocab, cfg.batch_size,
                                       cfg.frames_per_action, seed=seed))
    cfg.save_run_args(run, vocab)
    trainer.save_checkpoint(run, 2, 0)

    batch = make_inputs(cfg, vocab, cfg.batch_size, cfg.frames_per_action,
                        seed=0)
    args = tuple(jnp.asarray(batch[k]) for k in
                 ("imgs", "objs", "triplets", "actions", "boxes"))
    jm = JModel(config=jcfg, vocab=vocab)
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
    st = trainer.state
    mv = to_flax(mt, st.model.state_dict(), transposed_keys(st.model))
    dv = to_flax(dt, st.disc.state_dict(), transposed_keys(st.disc))
    return trainer, (mv, dv), run


def _same_rows(got, want):
    assert [r[0] for r in got] and \
        sorted(r[0] for r in got) == sorted(r[0] for r in want)
    want = {r[0]: r for r in want}
    for path, hat, true in got:
        assert hat == pytest.approx(want[path][1], rel=1e-6), path
        assert true == pytest.approx(want[path][2], rel=SIGMA_RTOL), path


def test_sigma_audit_matches_the_jax_tool(trained, capsys):
    trainer, (mv, dv), run = trained
    g = sigma_audit.spectral_rows(trainer.state.model)
    d = sigma_audit.spectral_rows(trainer.state.disc)
    _same_rows(g, audit_tree(mv["params"], mv["spectral"], "G"))
    _same_rows(d, audit_tree(dv["params"], dv["spectral"], "D"))
    # conv kernels in both networks, and the flow decoder's transposed ones
    model = trainer.state.model
    transposed = [p for p, _, _ in g if model.get_submodule(
        ".".join(p.split("/")[:-2])).spectral.transposed]
    assert len(g) == 24 and len(d) == 2 and len(transposed) == 2
    # The CLI reads the checkpoint back: the same rows, the JAX lines.
    capsys.readouterr()
    assert sigma_audit.main([run, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    ga, da = sigma_audit.audit(os.path.join(run, "itr_2"), "cpu")
    assert ga == g and da == d
    for line in ("G: ", "D: ", "  worst: ", "ALL: rel err mean "):
        assert line in out, out


def test_sigma_audit_reports_a_stale_sigma(trained, capsys):
    trainer, _, _ = trained
    model = trainer.state.model
    rows = sigma_audit.spectral_rows(model)
    path, _, true = rows[len(rows) // 2]
    sw = model.get_submodule(".".join(path.split("/")[:-2])).spectral
    saved = sw.sigma.clone()
    try:
        sw.sigma.fill_(1.5 * true)
        rows = sigma_audit.spectral_rows(model)
        errs = sigma_audit.rel_errors(rows)
        assert rows[int(np.argmax(errs))][0] == path
        assert max(errs) == pytest.approx(0.5, abs=1e-6)
        capsys.readouterr()
        sigma_audit.report(rows, "G")
        out = capsys.readouterr().out
        assert f"  worst: {path} " in out and "max 50.00%" in out
    finally:
        sw.sigma.copy_(saved)


def test_sigma_audit_needs_a_card_by_default(trained):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sigma_audit.audit(trained[2])


ROWS = [{"step": 3, "time": 10.0, "loss": 2.5, "count": 7},
        {"step": 7, "time": 11.0, "loss": 1.25, "tag": "s"},
        {"step": 0, "time": 0.0, "loss": 4.0, "nan_skipped": True},
        {"time": 12.5, "iou": 0.125},          # no step: the rows so far
        {"step": 9, "loss": -0.5},             # no time: the clock's
        {"step": 10, "time": 13.0, "flag": False}]   # nothing numeric


def _records(path):
    """(step, wall, tag, value) of an event file, by the port's reader and
    by tests/test_tfevents.py's own decoder, which must agree."""
    got = t_tfevents.read_events(path)
    want = [(ev["step"], ev["wall_time"], tag, value)
            for ev in map(_decode_event, _read_records(path))
            for tag, value in ev["scalars"].items()]
    assert got == want
    return got


def test_jsonl_to_tfevents_matches_the_jax_tool(tmp_path):
    dirs = {}
    for name in ("torch", "jax"):
        d = tmp_path / name
        d.mkdir()
        (d / "metrics.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in ROWS) + "\n")
        dirs[name] = str(d)
    paths = {"torch": t_tfevents.convert(dirs["torch"]),
             "jax": j_tfevents.convert(dirs["jax"])}
    got, want = _records(paths["torch"]), _records(paths["jax"])
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        if g[0] == 9:          # the conversion's clock on either side
            assert g[1] > 0 and w[1] > 0
            g, w = (g[0],) + g[2:], (w[0],) + w[2:]
        assert g == w
    assert got[:4] == [(3, 10.0, "loss", 2.5), (3, 10.0, "count", 7.0),
                       (7, 11.0, "loss", 1.25), (0, 0.0, "loss", 4.0)]
    assert got[4] == (3, 12.5, "iou", 0.125)
    # The rows read back: every numeric, non-bool column but step and time.
    for rec, (step, wall, tag, value) in zip(
            [(r.get("step", 3), r.get("time"), k, v)
             for r in ROWS for k, v in r.items()
             if k not in ("step", "time") and not isinstance(v, (bool, str))],
            got):
        assert rec[0] == step and rec[2:] == (tag, value)
        assert rec[1] is None or rec[1] == wall

    # A second conversion skips (it would duplicate the scalars), --force
    # writes a second file (each process names its own), as the JAX tool
    # does.
    for name, mod in (("torch", t_tfevents), ("jax", j_tfevents)):
        assert mod.convert(dirs[name]) == paths[name]
        cmd = [sys.executable, mod.__file__, dirs[name]]
        subprocess.run(cmd, check=True, capture_output=True)
        assert len(glob.glob(os.path.join(dirs[name], "events.*"))) == 1
        subprocess.run(cmd + ["--force"], check=True, capture_output=True)
        assert len(glob.glob(os.path.join(dirs[name], "events.*"))) == 2
