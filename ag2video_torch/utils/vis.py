"""Visualization artifacts (port of ag2video_tpu/utils/vis.py, held equal
to it by tests/test_torch_copies.py): frames with boxes drawn, gifs, and the
{'image','box'} pickle consumed by the LPIPS pair scorer, and the
per-checkpoint validation videos (`save_images`). The JAX package writes
its gifs with imageio; the port writes them itself (utils/gif.py: a fixed
256-colour palette, so a frame reads back within gif.MAX_ERROR per
channel), and needs no imageio."""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ag2video_torch.data.transforms import denormalize
from ag2video_torch.utils.gif import write_gif


def draw_boxes(frame: np.ndarray, boxes: np.ndarray,
               color=(1.0, 1.0, 1.0), skip_dummy: bool = True) -> np.ndarray:
    """Draw xywh boxes ([0,1] coords) as 1px rectangles on an HxWx3 frame."""
    H, W, _ = frame.shape
    out = frame.copy()
    for b in boxes:
        x0, y0, w, h = b
        if skip_dummy and (w >= 0.999 and h >= 0.999):
            continue  # whole-image dummy box
        if w <= 0 or h <= 0:
            continue
        xa = int(np.clip(x0 * W, 0, W - 1))
        ya = int(np.clip(y0 * H, 0, H - 1))
        xb = int(np.clip((x0 + w) * W, 0, W - 1))
        yb = int(np.clip((y0 + h) * H, 0, H - 1))
        out[ya, xa:xb + 1] = color
        out[yb, xa:xb + 1] = color
        out[ya:yb + 1, xa] = color
        out[ya:yb + 1, xb] = color
    return out


def plot_vid(video: np.ndarray, boxes: Optional[np.ndarray] = None) -> list:
    """ImageNet-normalized (T,H,W,3) -> list of uint8 frames, optionally with
    boxes drawn (reference plot_vid, models/vis.py:29-44)."""
    frames = []
    for t in range(video.shape[0]):
        f = denormalize(video[t])
        if boxes is not None:
            f = draw_boxes(f, boxes[t])
        frames.append((f * 255).astype(np.uint8))
    return frames


def save_gif(frames: Sequence[np.ndarray], path: str, fps: int = 4) -> str:
    """A looping gif of (H, W, 3) uint8 frames, each shown 1 / fps s."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return write_gif(path, frames, fps)


def save_video_pickle(path: str, video: np.ndarray, boxes: np.ndarray) -> str:
    """The reference's {'image','box'} pkl artifact (scripts/test.py:291-299)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"image": video, "box": boxes}, f)
    return path


def save_images(output_dir: str, t: int, samples: Dict, dir_name: str,
                max_videos: int = 4) -> None:
    """Per-val-checkpoint artifacts (reference save_images, models/vis.py:47-118):
    GT w/ GT boxes, GT w/ pred boxes, generated w/ both box sets."""
    base = os.path.join(output_dir, dir_name, f"itr_{t}")
    n = min(max_videos, len(samples.get("video_id", [])))
    for i in range(n):
        vid = samples["vids"][i]
        gt_boxes = samples["gt_boxes"][i]
        pred_boxes = samples["pred_boxes"][i]
        gen = samples["pred_vids"][i]
        vid_id = samples["video_id"][i]
        save_gif(plot_vid(vid, gt_boxes), os.path.join(base, f"{vid_id}_gt_gtbox.gif"))
        save_gif(plot_vid(vid, pred_boxes), os.path.join(base, f"{vid_id}_gt_predbox.gif"))
        save_gif(plot_vid(gen, gt_boxes), os.path.join(base, f"{vid_id}_gen_gtbox.gif"))
        save_gif(plot_vid(gen, pred_boxes), os.path.join(base, f"{vid_id}_gen_predbox.gif"))
