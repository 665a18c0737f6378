"""The port's evaluation stack against the JAX package's, on the CPU: the
weight-port CLI's assets (byte for byte, for all five networks, and what
each package loads from them), the video feature extractor with its .npy
cache, `load_clip`, PRD and the action metrics on numbers, and
`python -m ag2video_torch.scripts.evaluate` in all six modes with the JAX
CLI's JSON keys.

The assets come from seeded state dicts in the pretrained layouts
(torch_tools/eval_assets.py). The CLI runs with no assets, so on seeded
random networks (`--device cpu`), on 4 images or clips per directory."""

import ast
import json
import os
import pickle
import sys
import time

import numpy as np
import pytest

import torch
from threadpoolctl import threadpool_limits

from ag2video_tpu.eval import action_metrics as j_am
from ag2video_tpu.eval import inception as ji
from ag2video_tpu.eval import lpips as jl
from ag2video_tpu.eval import prd as j_prd
from ag2video_tpu.eval import video_backbones as jv
from ag2video_tpu.eval import video_score as j_vs
from ag2video_tpu.models import vgg as j_vgg
from ag2video_torch.data.png import write_png
from ag2video_torch.eval import action_metrics as t_am
from ag2video_torch.eval import inception as ti
from ag2video_torch.eval import lpips as tl
from ag2video_torch.eval import prd as t_prd
from ag2video_torch.eval import video_backbones as tv
from ag2video_torch.eval import video_score as t_vs
from ag2video_torch.models import vgg as t_vgg
from ag2video_torch.scripts import evaluate as t_eval
from ag2video_torch.scripts import port_torch_weights as t_port
from ag2video_torch.weights import flax_to_state_dict, from_flax
from scripts import port_torch_weights as j_port
from tests.test_torch_eval_nets import assert_net_close, variables
from torch_tools.eval_assets import (ASSET_NAMES, NETS, port_module,
                                     pretrained_key, state_dicts)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A zip entry's header holds its write time: both writes get this one.
FIXED_TIME = time.struct_time((2020, 1, 1, 0, 0, 0, 2, 1, 0))


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """scipy's sqrtm of a 2048x2048 product (each FID call) gains little
    from BLAS threads (15 s on one, 11 s on eight, alone on an 8-core
    CPU), and the test run shares the machine among its workers: one BLAS
    thread here."""
    with threadpool_limits(1):
        yield


def _write_asset(module, net, sd, lins, out):
    if net == "lpips_alex":
        module.port_lpips_alex(sd, out, lins)
    else:
        module.PORTERS[net](sd, out)


def _port_state(net, path):
    """The port's module of `net` loaded from the asset at `path`, and the
    JAX package's load of the same asset as port state-dict tensors."""
    if net == "vgg19":
        got = t_vgg.vgg19_from_arrays(t_vgg.load_vgg19_arrays(path))
        want = flax_to_state_dict(j_vgg.load_vgg19_params(path))
        assert len(want) == 32  # all 16 convs are in the asset
        return got.state_dict(), {k: v for k, v in want.items()
                                  if k in got.state_dict()}
    if net == "lpips_alex":
        j_lp, t_lp = jl.LPIPS(path), tl.LPIPS(path, device="cpu")
        for a, b in zip(t_lp.lin_weights, j_lp.lin_weights):
            np.testing.assert_array_equal(a, b)
        assert not t_lp.random_init
        return t_lp.net.state_dict(), flax_to_state_dict(j_lp.params)
    if net == "inception":
        tree, want = ti.load_inception_params(path), \
            ji.load_inception_params(path)
    else:
        backbone = "tsm" if net == "tsm" else "resnext"
        tree, want = tv.load_backbone_params(backbone, path), \
            jv.load_backbone_params(backbone, path)
    return from_flax(tree, port_module(net)).state_dict(), \
        flax_to_state_dict(want)


@pytest.mark.parametrize("net", NETS)
def test_assets_are_byte_equal_and_load_alike(net, tmp_path, monkeypatch):
    """One state dict through both packages' weight-port CLIs: the same
    bytes; the port's module loaded from the asset (strictly) holds what
    the JAX package loads from it, and the pretrained tensors themselves
    (so the OIHW -> HWIO / OITHW -> THWIO transposes round-trip)."""
    monkeypatch.setattr(time, "localtime", lambda *a: FIXED_TIME)
    sd, lins = state_dicts(net, seed=1)
    paths = {}
    for name, module in (("jax", j_port), ("torch", t_port)):
        paths[name] = str(tmp_path / f"{name}_{ASSET_NAMES[net]}")
        _write_asset(module, net, sd, lins, paths[name])
    with open(paths["jax"], "rb") as f, open(paths["torch"], "rb") as g:
        assert f.read() == g.read()
    got, want = _port_state(net, paths["torch"])
    assert set(got) == set(want) and len(got) > 0
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        if net != "vgg19":
            np.testing.assert_array_equal(got[k].numpy(),
                                          sd[pretrained_key(net, k)])


def test_port_cli_writes_the_jax_cli_bytes(tmp_path, monkeypatch):
    """The CLIs themselves, on .npz state dicts (LPIPS with its lins);
    --from_torchvision needs torchvision, which fails with its own error."""
    monkeypatch.setattr(time, "localtime", lambda *a: FIXED_TIME)
    sd, lins = state_dicts("lpips_alex", seed=2)
    np.savez(tmp_path / "sd.npz", **sd)
    np.savez(tmp_path / "lins.npz", **lins)
    out = {}
    for name, module in (("jax", j_port), ("torch", t_port)):
        out[name] = str(tmp_path / f"{name}.npz")
        module.main(["--net", "lpips_alex", "--state_dict",
                     str(tmp_path / "sd.npz"), "--lpips_state_dict",
                     str(tmp_path / "lins.npz"), "--out", out[name]])
    with open(out["jax"], "rb") as f, open(out["torch"], "rb") as g:
        assert f.read() == g.read()
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="torchvision"):
            t_port.main(["--net", "inception", "--from_torchvision",
                         "--out", str(tmp_path / "x.npz")])


def _clips(directory, n, T, H, W, seed):
    rng = np.random.RandomState(seed)
    os.makedirs(directory)
    for i in range(n):
        image = rng.randn(T, H, W, 3).astype(np.float32)
        with open(os.path.join(directory, f"clip_{i}.pkl"), "wb") as f:
            pickle.dump({"image": image, "box": rng.uniform(
                0, 1, (T, 3, 4)).astype(np.float32)}, f)


def test_load_clip_matches(tmp_path):
    _clips(str(tmp_path / "c"), 1, 5, 20, 24, seed=3)
    path = str(tmp_path / "c" / "clip_0.pkl")
    bare = str(tmp_path / "bare.pkl")
    with open(path, "rb") as f, open(bare, "wb") as g:
        pickle.dump(pickle.load(f)["image"][..., :1], g)  # one channel
    for p in (path, bare):
        want = j_vs.load_clip(p, 7, (16, 12))
        got = t_vs.load_clip(p, 7, (16, 12))
        assert got.shape == (7, 16, 12, 3)
        np.testing.assert_array_equal(got, want)


def test_video_feature_extractor_matches(tmp_path, monkeypatch):
    """The same clips and params through both extractors (TSM, 4 frames
    at 32x32, batches of 2): the same features, and the same cache file
    next to each directory; a second call reads the cache."""
    v = variables(jv.TSMResNet50(), (1, 4, 32, 32, 3))
    for name in ("jax", "torch"):
        _clips(str(tmp_path / name), 4, 6, 40, 48, seed=4)
    kw = dict(n_frames=4, size=(32, 32), batch_size=2)
    want = j_vs.VideoFeatureExtractor("tsm", v, **kw).extract_dir(
        str(tmp_path / "jax"))
    ex = t_vs.VideoFeatureExtractor("tsm", v, device="cpu", **kw)
    assert not ex.random_init
    got = ex.extract_dir(str(tmp_path / "torch"))
    assert got.shape == (4, 2048)
    assert_net_close(got, want, "clip features")
    cached = [np.load(tmp_path / name / "features_tsm.npy")
              for name in ("jax", "torch")]
    assert cached[1].dtype == cached[0].dtype
    np.testing.assert_array_equal(cached[1], got)

    def no_forward(*a):
        raise AssertionError("the cache was not read")

    monkeypatch.setattr(t_vs.VideoFeatureExtractor, "features", no_forward)
    np.testing.assert_array_equal(ex.extract_dir(str(tmp_path / "torch")),
                                  got)


def test_prd_and_action_metrics_match(rng):
    e, r = rng.randn(30, 6), rng.randn(40, 6) + 0.5
    want = j_prd.prd_from_embedding(e, r, num_clusters=5, num_runs=3)
    got = t_prd.prd_from_embedding(e, r, num_clusters=5, num_runs=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert t_prd.prd_to_max_f_beta_pair(*got) == \
        j_prd.prd_to_max_f_beta_pair(*want)

    probs = rng.dirichlet(np.ones(4), 12)
    actions = ["a", "b", "c"]
    assert t_am.quant(probs, actions) == j_am.quant(probs, actions)
    pred, gt = rng.randint(0, 4, 20), rng.randint(0, 4, 20)
    np.testing.assert_array_equal(t_am.confusion_matrix(4, pred, gt),
                                  j_am.confusion_matrix(4, pred, gt))
    f1, f2 = rng.randn(30, 3), rng.randn(24, 3)
    c1, c2 = rng.randint(0, 3, 30), rng.randint(0, 3, 24)
    assert t_am.per_class_fid(f1, f2, c1, c2, full=False) == \
        j_am.per_class_fid(f1, f2, c1, c2, full=False)
    np.testing.assert_allclose(t_am.per_class_fid(f1, f2, c1, c2),
                               j_am.per_class_fid(f1, f2, c1, c2),
                               rtol=1e-12)


# ------------------------------------------------------------------ CLI
MODES = ["image_fid", "video_fid", "video_prd", "lpips_videos",
         "lpips_dirs", "is"]


def jax_cli_keys():
    """{mode: the keys of the JSON line} of scripts/evaluate.py, read from
    its `result = {...}` literals (one per mode, in the modes' order)."""
    with open(os.path.join(REPO, "scripts", "evaluate.py")) as f:
        tree = ast.parse(f.read())
    keys = [sorted(k.value for k in n.value.keys) for n in ast.walk(tree)
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
            and any(getattr(t, "id", None) == "result" for t in n.targets)]
    assert len(keys) == len(MODES)
    return dict(zip(MODES, keys))


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaluate")
    rng = np.random.RandomState(8)
    for name in ("a", "b"):
        os.makedirs(root / name)
        for i in range(4):
            write_png(str(root / name / f"{i}.png"),
                      rng.randint(0, 256, (40, 48, 3)).astype(np.uint8))
    _clips(str(root / "gen"), 4, 3, 32, 32, seed=9)
    _clips(str(root / "ref"), 4, 3, 32, 32, seed=10)
    return {k: str(root / k) for k in ("a", "b", "gen", "ref")}


def run_cli(capsys, *argv):
    result = t_eval.main([*argv, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(result))
    assert all(np.isfinite(v) for v in result.values()), result
    return result


def test_evaluate_cli_image_modes(cli_dirs, capsys):
    keys = jax_cli_keys()
    a, b = cli_dirs["a"], cli_dirs["b"]
    fid = run_cli(capsys, "image_fid", a, a)
    feats, _ = t_eval._inception_pool3(t_eval._load_images(a), device="cpu")
    scale = 2 * np.trace(np.cov(feats, rowvar=False))
    assert abs(fid["image_fid"]) <= 1e-3 * scale, (fid, scale)
    same = run_cli(capsys, "lpips_dirs", a, a)
    assert same == {"lpips": 0.0, "n_pairs": 4}
    other = run_cli(capsys, "lpips_dirs", a, b, "--limit", "3")
    assert other["lpips"] > 0 and other["n_pairs"] == 3
    score = run_cli(capsys, "is", a)
    for mode, result in (("image_fid", fid), ("lpips_dirs", same),
                         ("is", score)):
        assert sorted(result) == keys[mode], mode


def test_evaluate_cli_video_modes(cli_dirs, capsys, monkeypatch):
    """video_fid extracts and caches both directories' features; video_prd
    after it reads them from the cache (no forward runs)."""
    keys = jax_cli_keys()
    gen, ref = cli_dirs["gen"], cli_dirs["ref"]
    results = {"video_fid": run_cli(capsys, "video_fid", gen, ref)}
    for d in (gen, ref):
        assert np.load(os.path.join(d, "features_tsm.npy")).shape == \
            (4, 2048)

    def no_forward(*a):
        raise AssertionError("the feature cache was not read")

    with monkeypatch.context() as m:
        m.setattr(t_vs.VideoFeatureExtractor, "features", no_forward)
        results["video_prd"] = run_cli(capsys, "video_prd", gen, ref)
    results["lpips_videos"] = run_cli(capsys, "lpips_videos", gen, ref)
    assert results["lpips_videos"]["n_pairs"] == 4
    assert results["lpips_videos"]["lpips"] > 0
    for mode, result in results.items():
        assert sorted(result) == keys[mode], mode


def test_evaluate_cli_runs_on_the_card_by_default(cli_dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_eval.main(["lpips_dirs", cli_dirs["a"], cli_dirs["a"]])


def test_evaluate_cli_image_modes_need_pil(cli_dirs, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="evaluate is: .*PIL"):
        t_eval.main(["is", cli_dirs["a"], "--device", "cpu"])
