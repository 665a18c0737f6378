"""The port runs where JAX is absent: every ag2video_torch module and
chip_smoke.py import with jax and flax blocked, and a CPU call of the
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
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
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
assert not any(m.split(".")[0] in ("jax", "flax") for m in sys.modules)
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
    assert n >= 15  # every module of the package, not just the root


def test_chip_smoke_fails_without_a_card():
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
