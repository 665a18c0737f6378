"""Synthetic-calibrated fidelity backbone (port of
ag2video_tpu/eval/backbone.py).

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
  - `train_backbone`: trains it on real rendered frames (labels free,
    `make_frame_dataset`): AdamW (lr 2e-3, weight decay 1e-4 on every
    parameter, as `optax.adamw`), BCE-with-logits on both heads, a random
    H/V flip per sample (the grid labels flipped to match) drawn from a
    `torch.Generator(seed)` on the training device; the frame set is
    uploaded once and each batch is gathered on the device.
  - `eval_backbone`: held-out accuracy of both heads.
  - `save_backbone` / `load_backbone`: the JAX package's asset format (a
    pickled `{"params": {...}}` of numpy arrays with flax names and HWIO
    kernels, plus `meta`), so either package loads the other's asset.
  - `FidelityScore`: the val loop's accumulator — feature-FID(generated,
    real) and presence accuracy of generated frames against the clip's
    ground-truth labels.

scripts/train_backbone.py drives the training.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ag2video_torch.eval.fid import fid_from_features
from ag2video_torch.models.layers import Conv, Dense
from ag2video_torch.models.normalization import fp32_stats, normalize
from ag2video_torch.weights import from_flax, init_params, to_flax

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


def _area_downsample_np(x: np.ndarray, size: int = INPUT_SIZE) -> np.ndarray:
    """Host-side twin of _resize64's area path for training data."""
    N, H, W, C = x.shape
    assert H % size == 0 and W % size == 0, (H, W, size)
    fh, fw = H // size, W // size
    return x.reshape(N, size, fh, size, fw, C).mean(axis=(2, 4),
                                                    dtype=np.float32)


def _device(device: Optional[Union[str, torch.device]], who: str
            ) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA card is available; pass "
                           f"device='cpu' to run on the CPU")
    return device


# ----------------------------------------------------------------------
# Training (scripts/train_backbone.py drives this)

def make_frame_dataset(cfg, n_videos: int, partition: str,
                       frames_per_video: int = 2, seed: int = 0,
                       image_size: Optional[Tuple[int, int]] = None,
                       render_size: Optional[Tuple[int, int]] = None):
    """Render `n_videos * frames_per_video` real frames + labels from the
    synthetic dataset (data/synthetic.py). By default frames come back at
    the backbone's INPUT_SIZE; render_size renders LARGER and
    area-downsamples to INPUT_SIZE (the antialiased domain the val pass
    feeds: run-resolution frames area-pooled by _resize64); image_size
    returns frames at a raw resolution instead. Returns host arrays
    (frames (N, H, W, 3) ImageNet-normalized, presence (N, 18), grid
    (N, GRID, GRID)), equal to the JAX package's."""
    from ag2video_torch.data.synthetic import SyntheticDataset

    assert not (image_size and render_size)
    ds = SyntheticDataset(
        partition=partition,
        image_size=image_size or render_size or (INPUT_SIZE, INPUT_SIZE),
        frames_per_action=cfg.frames_per_action,
        dataset_size=n_videos,
        number_of_objects=min(cfg.number_of_objects, cfg.max_objects - 1),
        seed=cfg.seed,
        max_actions=cfg.max_actions,
        dynamics=cfg.synthetic_dynamics,
    )
    rng = np.random.RandomState(seed)
    frames, pres, grids = [], [], []
    for i in range(n_videos):
        vids, objs, boxes, _, _, _ = ds[i]
        T = vids.shape[0]
        ts = rng.choice(T, size=min(frames_per_video, T), replace=False)
        p = presence_labels({k: v[None] for k, v in objs.items()})[0]
        g = grid_labels(boxes[None], {k: v[None] for k, v in objs.items()})[0]
        for t in ts:
            frames.append(vids[t])
            pres.append(p)
            grids.append(g[t])
    out = np.stack(frames)
    if render_size is not None:
        out = _area_downsample_np(out)
    return (out, np.stack(pres), np.stack(grids))


def backbone_optimizer(model: nn.Module, lr: float = 2e-3,
                       weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=...): b1 0.9, b2 0.999, eps 1e-8, the
    decay on every parameter."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def flip_batch(xb: torch.Tensor, yg: torch.Tensor, fh: torch.Tensor,
               fv: torch.Tensor):
    """Per-sample flips: fh (N,) bool flips W, fv (N,) bool flips H; the
    grid labels (N, GRID, GRID) flip with the image."""
    xb = torch.where(fh[:, None, None, None], xb.flip(2), xb)
    xb = torch.where(fv[:, None, None, None], xb.flip(1), xb)
    yg = torch.where(fh[:, None, None], yg.flip(2), yg)
    yg = torch.where(fv[:, None, None], yg.flip(1), yg)
    return xb, yg


def backbone_step(model: nn.Module, opt: torch.optim.Optimizer,
                  xb: torch.Tensor, yp: torch.Tensor, yg: torch.Tensor):
    """One AdamW step on a (flipped) batch -> (loss, (presence loss, grid
    loss, presence accuracy)), 0-dim tensors."""
    opt.zero_grad(set_to_none=True)
    _, pl, gl = model(xb)
    lp = F.binary_cross_entropy_with_logits(pl, yp)
    lg = F.binary_cross_entropy_with_logits(gl, yg)
    acc = ((pl > 0) == (yp > 0.5)).float().mean()
    tot = lp + lg
    tot.backward()
    opt.step()
    return tot.detach(), (lp.detach(), lg.detach(), acc)


def backbone_params(model: SyntheticEvalBackbone) -> Dict[str, Any]:
    """The module's weights as the JAX package's tree: {'params': {conv<i>:
    {kernel (HWIO), bias}, gn<i>: {scale, bias}, presence: {kernel (in,
    out), bias}, grid: {kernel, bias}}} of fp32 numpy arrays."""
    leaf = {"kernel": None, "bias": None}
    tree: Dict[str, Any] = {}
    for i in range(len(WIDTHS)):
        tree[f"conv{i}"] = leaf
        tree[f"gn{i}"] = {"scale": None, "bias": None}
    tree["presence"] = leaf
    tree["grid"] = leaf
    return to_flax({"params": tree}, model.state_dict())


def train_backbone(frames: np.ndarray, pres: np.ndarray, grids: np.ndarray,
                   steps: int = 2000, batch_size: int = 256,
                   lr: float = 2e-3, seed: int = 0, log_every: int = 200,
                   log=None, weight_decay: float = 1e-4,
                   device: Optional[Union[str, torch.device]] = None):
    """Train a seeded SyntheticEvalBackbone on `device` (None: the CUDA
    card) -> (params as the JAX package's tree, history). The frame set is
    uploaded once; each step draws its batch indices and flips from one
    `torch.Generator(seed)` on the device and gathers the batch there.
    Presence labels are constant per video, so the effective sample count
    is videos, not frames: the flips and the weight decay keep the
    held-out gap in check."""
    device = _device(device, "train_backbone")
    model = init_params(SyntheticEvalBackbone(), seed).to(device)
    opt = backbone_optimizer(model, lr, weight_decay)
    d_frames = torch.as_tensor(frames, dtype=torch.float32).to(device)
    d_pres = torch.as_tensor(pres, dtype=torch.float32).to(device)
    d_grid = torch.as_tensor(grids, dtype=torch.float32).to(device)
    n = d_frames.shape[0]
    g = torch.Generator(device=device).manual_seed(seed)
    hist = []
    for t in range(steps):
        idx = torch.randint(0, n, (batch_size,), generator=g, device=device)
        fh, fv = torch.rand(2, batch_size, generator=g, device=device) < 0.5
        xb, yg = flip_batch(d_frames[idx], d_grid[idx], fh, fv)
        tot, aux = backbone_step(model, opt, xb, d_pres[idx], yg)
        if log is not None and (t % log_every == 0 or t == steps - 1):
            lp, lg, acc = (float(a) for a in aux)
            log.info("backbone step %d/%d loss=%.4f presence=%.4f "
                     "grid=%.4f batch_acc=%.4f", t, steps, float(tot),
                     lp, lg, acc)
            hist.append({"t": t, "loss": float(tot), "acc": acc})
    return backbone_params(model), hist


def eval_backbone(params: Mapping[str, Any], frames: np.ndarray,
                  pres: np.ndarray, grids: np.ndarray, batch_size: int = 256,
                  device: Optional[Union[str, torch.device]] = None):
    """Held-out accuracy of both heads on real frames (the calibration
    evidence: the metric has signal only if this is high)."""
    device = _device(device, "eval_backbone")
    model = backbone_from_params(params).to(device).eval()
    n_ok_p = n_p = n_ok_g = n_g = 0
    for i in range(0, frames.shape[0], batch_size):
        xb = torch.as_tensor(frames[i:i + batch_size]).float().to(device)
        with torch.no_grad():
            _, pl, gl = model(xb)
        pl, gl = pl.cpu().numpy(), gl.cpu().numpy()
        yp = pres[i:i + batch_size] > 0.5
        yg = grids[i:i + batch_size] > 0.5
        n_ok_p += ((pl > 0) == yp).sum()
        n_p += yp.size
        n_ok_g += ((gl > 0) == yg).sum()
        n_g += yg.size
    return {"presence_acc": float(n_ok_p) / max(n_p, 1),
            "grid_acc": float(n_ok_g) / max(n_g, 1)}


def save_backbone(params: Mapping[str, Any], path: str = DEFAULT_WEIGHTS,
                  meta: Optional[dict] = None) -> str:
    """Write the JAX package's asset format: the pickled params tree and
    the pickled meta, each as a uint8 array of an .npz."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, params=np.frombuffer(pickle.dumps(params), np.uint8),
             meta=np.frombuffer(pickle.dumps(meta or {}), np.uint8))
    return path


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
        self.device = _device(device, "FidelityScore")
        self.model = backbone_from_params(params).to(self.device).eval()
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
