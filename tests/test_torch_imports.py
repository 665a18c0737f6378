"""The port runs where JAX is absent: every ag2video_torch module (the
training run's, the evaluation stack's and the CLIs' among them),
chip_smoke.py and the run tools' twins (torch_tools/{sigma_audit,
jsonl_to_tfevents,trajectory}.py) import with jax,
flax and the JAX package itself (ag2video_tpu) blocked, and with PIL,
pandas, cv2 and imageio blocked too (a machine may lack them; they are
imported only inside the functions that need them), and a CPU call of the
rasterizer launches no kernel. The CATER training path (a PNG cache written
and read, `clip_transform`'s default branch) runs with those four blocked,
and the branches that need PIL say so. Each module also imports as a
process's first import of the package (an import cycle shows only in that
order). chip_smoke.py refuses to run without a card and prints no result."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "ag2video_tpu",
                                  "imageio", "PIL", "pandas", "cv2"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import ag2video_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    ag2video_torch.__path__, "ag2video_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
for name in ("sigma_audit", "jsonl_to_tfevents", "trajectory"):
    importlib.import_module("torch_tools." + name)
    print("TOOL", name)

import torch
from ag2video_torch.ops import rasterize as tr
vecs = torch.randn(2, 3, 4, 8)
boxes = torch.rand(2, 3, 4, 4)
out = tr.boxes_to_layout_batch(vecs, boxes, 8)
assert out.shape == (2, 3, 8, 8, 8), out.shape
assert tr.KERNEL_LAUNCHES.n == 0 and tr.PLAIN_CALLS.n == 1
assert not any(m.split(".")[0] in ("jax", "flax", "ag2video_tpu")
               for m in sys.modules)
print("\n".join(names))
print("IMPORTED", len(names))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=cwd, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


FIRST_IMPORTS = r"""
import importlib, pkgutil, sys, traceback
import torch  # once: each module below is then the package's first import
import ag2video_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    ag2video_torch.__path__, "ag2video_torch."))
failed = []
for name in names:
    for m in [m for m in sys.modules if m.split(".")[0] == "ag2video_torch"]:
        del sys.modules[m]
    try:
        importlib.import_module(name)
    except Exception:
        failed.append(name + ": " + traceback.format_exc().splitlines()[-1])
print("FAILED", len(failed))
print("\n".join(failed))
print("IMPORTED", len(names) - len(failed), "OF", len(names))
"""


def test_each_module_imports_first():
    proc = _run(["-c", FIRST_IMPORTS], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    failed = proc.stdout.split("FAILED")[1].split("IMPORTED")[0].split()
    assert failed[0] == "0", proc.stdout.split("FAILED")[1]
    assert int(proc.stdout.split("OF")[1]) >= 75


def test_port_imports_without_jax():
    proc = _run(["-c", BLOCKED_IMPORTS], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("IMPORTED")[1])
    # every module of the package, not just the root: the training step's
    # losses, discriminator, vgg and train modules, the training run's
    # data, evaluation, checkpoint, telemetry and CLI modules, and the
    # evaluation stack's networks, metrics and CLIs, the rule baseline and
    # the backbone-training and layout-IoU CLIs among them, and the latent
    # modules (grid sampling, crops, the discriminator variants, the VAE
    # encoder, the graph algebra), and data parallel (the parallel package)
    assert n >= 75
    for name in ("losses.loss_model", "models.discriminator", "models.vgg",
                 "train.trainer", "train.checkpoint", "data.synthetic",
                 "data.registry", "eval.backbone", "eval.fid", "ops.boxes",
                 "ops.metrics", "utils.logging", "utils.tfevents",
                 "utils.profiling", "scripts.train", "data.native",
                 "data.png", "data.transforms", "data.cater", "data.smth",
                 "scripts.generate", "scripts.eval_fidelity",
                 "scripts.summarize_metrics", "eval.layers", "eval.inception",
                 "eval.lpips", "eval.video_backbones", "eval.video_score",
                 "eval.prd", "eval.action_metrics", "scripts.evaluate",
                 "scripts.port_torch_weights", "models.rule_baseline",
                 "scripts.train_backbone", "scripts.eval_iou",
                 "ops.sampling", "ops.crop", "models.discriminator_variants",
                 "models.encoder", "utils.graphs", "parallel",
                 "parallel.mesh", "utils.gif"):
        assert f"ag2video_torch.{name}" in proc.stdout
    # the run tools' twins and the trajectory check, without JAX
    for name in ("sigma_audit", "jsonl_to_tfevents", "trajectory"):
        assert f"TOOL {name}" in proc.stdout


CATER_WITHOUT_PIL = BLOCKED_IMPORTS.split("import ag2video_torch")[0] + r"""
import os, sys, tempfile
import numpy as np
from torch_tools.cater_tree import make_tree
from ag2video_torch.data.cater import CATERDataset
from ag2video_torch.data.png import read_frame
from ag2video_torch.data.transforms import clip_transform

with tempfile.TemporaryDirectory() as d:
    root, splits, names = make_tree(d, n_videos=2, nframes=60, n_objects=3,
                                    size=(40, 30), threads=2)
    ds = CATERDataset(os.path.join(splits, "train.txt"), root,
                      image_size=(16, 16), frames_per_action=4,
                      initial_frames_per_sample=12, nframes=60)
    vids, objs, boxes, triplets, actions, name = ds[1]
    assert vids.shape == (4, 16, 16, 3) and name.startswith(names[1])
    frame = read_frame(os.path.join(root, "videos", names[0], "00007.png"))
    assert frame.shape == (30, 40, 3) and frame.dtype == np.uint8
    clip = clip_transform([frame] * 3, (12, 20))
    assert clip.shape == (3, 12, 20, 3) and clip.dtype == np.float32
    for call in (lambda: clip_transform([frame], (8, 8), "crop"),
                 lambda: read_frame(os.path.join(d, "a.jpg"))):
        try:
            call()
        except ImportError as e:
            assert "PIL" in str(e), e
        else:
            raise AssertionError("a branch that needs PIL ran without it")
assert not any(m.split(".")[0] in ("PIL", "pandas", "cv2", "imageio")
               for m in sys.modules)
print("CATER OK")
"""


def test_cater_path_runs_without_pil_pandas_cv2_imageio():
    proc = _run(["-c", CATER_WITHOUT_PIL], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "CATER OK" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
