"""The port runs where JAX is absent: every ag2video_torch module (the
training run's among them) and chip_smoke.py import with jax, flax and the
JAX package itself
(ag2video_tpu) blocked, and with imageio blocked too (the card machine
lacks it; only `utils.vis.save_gif` imports it, when called), and a CPU
call of the
rasterizer launches no kernel. chip_smoke.py refuses to run without a card
and prints no result."""

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
                                  "imageio"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import ag2video_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    ag2video_torch.__path__, "ag2video_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke

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


def test_port_imports_without_jax():
    proc = _run(["-c", BLOCKED_IMPORTS], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n = int(proc.stdout.split("IMPORTED")[1])
    # every module of the package, not just the root: the training step's
    # losses, discriminator, vgg and train modules, and the training run's
    # data, evaluation, checkpoint, telemetry and CLI modules among them
    assert n >= 49
    for name in ("losses.loss_model", "models.discriminator", "models.vgg",
                 "train.trainer", "train.checkpoint", "data.synthetic",
                 "data.registry", "eval.backbone", "eval.fid", "ops.boxes",
                 "ops.metrics", "utils.logging", "utils.tfevents",
                 "utils.profiling", "scripts.train"):
        assert f"ag2video_torch.{name}" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
