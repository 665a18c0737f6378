"""Synthetic-calibrated fidelity backbone (port of
ag2video_tpu/eval/backbone.py:39-131, 275-342).

The reference scores generated frames with a pretrained InceptionV3 at
every val pass (reference evaluation/inception.py:35-49,
scripts/train.py:175,247). No pretrained weights are in the repository, but
the synthetic dataset has free labels (per-object shape/color, per-frame
box positions), and the JAX package trained a small classifier on them; its
weights are committed as assets/synthetic_backbone.npz (a pickled dict of
numpy arrays, read here without JAX).

  - `SyntheticEvalBackbone`: a 4-stage CNN; `features` = the 256-d GAP
    embedding (the FID space), plus a presence head (18-way multi-label
    "a {shape}x{color} object is visible") and a grid head (GRIDxGRID
    occupancy of object centres).
  - `FidelityScore`: the val loop's accumulator — feature-FID(generated,
    real) and presence accuracy of generated frames against the clip's
    ground-truth labels.

`train_backbone`, `make_frame_dataset`, `eval_backbone` and their
`_area_downsample_np` are not ported yet: they come with
`scripts/train_backbone.py` (ROADMAP.md).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ag2video_torch.eval.fid import fid_from_features
from ag2video_torch.models.layers import Conv, Dense
from ag2video_torch.models.normalization import fp32_stats, normalize
from ag2video_torch.weights import from_flax

N_SHAPES = 3   # square / disc / diamond (data/synthetic.py shapes 1..3)
N_COLORS = 6   # COLOR_RGB ids 1..6
N_PRESENCE = N_SHAPES * N_COLORS
GRID = 4
INPUT_SIZE = 64  # frames are resized here before the forward
WIDTHS = (32, 64, 128, 256)

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "synthetic_backbone.npz",
)


class _GroupNorm(nn.Module):
    """flax nn.GroupNorm(num_groups) with its scale and bias: per sample,
    fp32 statistics over the spatial axes and each group's channels (the
    fast variance), eps 1e-6."""

    def __init__(self, features: int, num_groups: int = 8, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.num_groups, self.eps = num_groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, H, W, C = x.shape
        G = self.num_groups
        mean, var = fp32_stats(x.reshape(N, H, W, G, C // G), (1, 2, 4))
        shape = (N, 1, 1, C)
        mean = mean.repeat_interleave(C // G, -1).reshape(shape)
        var = var.repeat_interleave(C // G, -1).reshape(shape)
        return normalize(x, mean, var, self.eps, self.weight, self.bias, None)


class SyntheticEvalBackbone(nn.Module):
    """4-stage stride-2 CNN: 64^2 -> 4^2, widths 32-64-128-256 (3x3 convs
    with flax's 'SAME' padding, GroupNorm(8), leaky-relu 0.2).

    forward(x (N, 64, 64, 3)) -> (features (N, 256), presence_logits
    (N, 18), grid_logits (N, GRID, GRID)). GroupNorm, not BatchNorm: an
    eval metric must not depend on the batch's composition."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for i, width in enumerate(WIDTHS):
            setattr(self, f"conv{i}", Conv(c_in, width, 3, stride=2))
            setattr(self, f"gn{i}", _GroupNorm(width))
            c_in = width
        self.presence = Dense(c_in, N_PRESENCE)
        self.grid = Conv(c_in, 1, 1)

    def forward(self, x: torch.Tensor):
        for i in range(len(WIDTHS)):
            x = getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x))
            x = F.leaky_relu(x, 0.2)
        feats = x.mean(dim=(1, 2))                             # (N, 256)
        return feats, self.presence(feats), self.grid(x)[..., 0]


# ----------------------------------------------------------------------
# Label builders (numpy copies of the JAX package's)

def presence_labels(objs: Dict[str, np.ndarray]) -> np.ndarray:
    """(B, N_PRESENCE) multi-label: a real object with (shape s, color c)
    exists. Dummy __image__ object and padding both have first-attribute
    id 0 (repo convention), so they drop out."""
    shape = np.asarray(objs["shape"])
    color = np.asarray(objs["color"])
    real = shape > 0
    idx = (shape - 1) * N_COLORS + (color - 1)                 # (B, O)
    lab = np.zeros((shape.shape[0], N_PRESENCE), np.float32)
    b, o = np.nonzero(real)
    lab[b, idx[b, o]] = 1.0
    return lab


def grid_labels(boxes: np.ndarray, objs: Dict[str, np.ndarray]) -> np.ndarray:
    """(B, T, GRID, GRID) occupancy: an object CENTER lies in the cell.
    boxes: (B, T, O, 4) xywh in [0,1]."""
    shape = np.asarray(objs["shape"])                          # (B, O)
    boxes = np.asarray(boxes)
    B, T, O, _ = boxes.shape
    cx = boxes[..., 0] + boxes[..., 2] / 2
    cy = boxes[..., 1] + boxes[..., 3] / 2
    ix = np.clip((cx * GRID).astype(int), 0, GRID - 1)
    iy = np.clip((cy * GRID).astype(int), 0, GRID - 1)
    lab = np.zeros((B, T, GRID, GRID), np.float32)
    real = np.broadcast_to((shape > 0)[:, None, :], (B, T, O))
    b, t, o = np.nonzero(real)
    lab[b, t, iy[b, t, o], ix[b, t, o]] = 1.0
    return lab


def _resize64(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, 64, 64, C), in x's dtype. Integer factors
    (256 -> 64, the val pass's case) area-average, as the JAX package does.
    Otherwise a bilinear resize with antialiasing
    (`F.interpolate(antialias=True)`): like `jax.image.resize(...,
    "bilinear")` it weights by the triangle kernel widened to the
    downsampling factor, and agrees with it to fp32 rounding
    (tests/test_torch_eval.py states the tolerance)."""
    N, H, W, C = x.shape
    if H == INPUT_SIZE and W == INPUT_SIZE:
        return x
    if H % INPUT_SIZE == 0 and W % INPUT_SIZE == 0:
        fh, fw = H // INPUT_SIZE, W // INPUT_SIZE
        return x.reshape(N, INPUT_SIZE, fh, INPUT_SIZE, fw, C).mean(dim=(2, 4))
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(INPUT_SIZE, INPUT_SIZE),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


def load_backbone(path: str = DEFAULT_WEIGHTS):
    """Returns (params, meta) or None if no trained asset exists. params is
    the flax variable tree {'params': {...}} as numpy arrays."""
    if not path or not os.path.exists(path):
        return None
    data = np.load(path, allow_pickle=False)
    params = pickle.loads(data["params"].tobytes())
    meta = pickle.loads(data["meta"].tobytes()) if "meta" in data else {}
    return params, meta


def backbone_from_params(params: Mapping[str, Any]) -> SyntheticEvalBackbone:
    """A SyntheticEvalBackbone holding the flax variables `params`
    ({'params': ...}), loaded strictly (weights.from_flax)."""
    return from_flax(params, SyntheticEvalBackbone())


# ----------------------------------------------------------------------
# The val-loop scorer

class FidelityScore:
    """Accumulates backbone features over generated AND real frames, plus
    presence predictions of generated frames vs ground-truth labels.

    compute() returns:
      fidelity_fid     — feature-FID(generated, real);
      fidelity_presence_acc — fraction of (frame, shape x color) presence
                         bits the classifier gets right on GENERATED
                         frames.
    """

    def __init__(self, params: Mapping[str, Any],
                 device: Optional[Union[str, torch.device]] = None):
        """device: where the backbone runs; None means the CUDA card, which
        raises without one."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("FidelityScore: no CUDA card is available; "
                               "pass device='cpu' to score on the CPU")
        self.device = device
        self.model = backbone_from_params(params).to(device).eval()
        self.clean()

    def clean(self):
        self._fake_feats, self._real_feats = [], []
        self._n_ok, self._n_tot = 0, 0

    def _features(self, imgs):
        # Resized in the frames' dtype, then the fp32 backbone: flax
        # promotes bf16 frames to the fp32 parameters' type.
        x = _resize64(torch.as_tensor(imgs).to(self.device))
        with torch.no_grad():
            return self.model(x.float())

    def add_fake(self, imgs, presence: Optional[np.ndarray] = None):
        """imgs: (N, H, W, 3) ImageNet-normalized generated frames (a tensor
        or an array); presence: optional (N, 18) ground-truth labels."""
        feats, pl, _ = self._features(imgs)
        self._fake_feats.append(feats.cpu().numpy().astype(np.float32))
        if presence is not None:
            pred = pl.cpu().numpy() > 0
            self._n_ok += int((pred == (presence > 0.5)).sum())
            self._n_tot += int(presence.size)

    def add_real(self, imgs):
        feats, _, _ = self._features(imgs)
        self._real_feats.append(feats.cpu().numpy().astype(np.float32))

    def compute(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self._fake_feats and self._real_feats:
            out["fidelity_fid"] = fid_from_features(
                np.concatenate(self._fake_feats),
                np.concatenate(self._real_feats))
        if self._n_tot:
            out["fidelity_presence_acc"] = self._n_ok / self._n_tot
        return out
