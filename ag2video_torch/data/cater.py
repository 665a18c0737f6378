"""CATER dataset (port of ag2video_tpu/data/cater.py; reference
data/cater.py:16-467).

Boxes are derived *analytically* from each scene JSON's 3D object
trajectories via the fixed CATER camera projection, with per-(shape, size)
2D box extents; frames come from the .avi videos, decoded once into a PNG
cache directory next to each video (the reference's cache-then-train
contract, cater.py:421-444). Actions shorter than 12 frames are skipped;
five corrupt videos are blacklisted; the whole-image dummy object (box
[0, 0, 1, 1]) is appended to every scene.

Differences from the reference (documented):
  - scene JSONs load lazily with an in-memory cache instead of all-at-init
    (cater.py:124-133 loads every JSON up front).
  - video decode uses cv2.VideoCapture instead of skvideo/FFmpegReader
    (same PNG cache layout: videos/<id>/%05d.png).

The port reads the PNG cache with data/png.py (no PIL) and resizes with the
host library (data/transforms.py, data/native.py), so the training path
imports neither PIL nor cv2. cv2 is imported only to decode a video whose
cache is missing, before the cache directory is made (the JAX loader makes
it first and leaves it empty when cv2 is absent). `cache_all`'s last shard
takes the remainder that the JAX loader's integer division leaves out.
The split files in CATER/ are byte-for-byte copies of the JAX package's.
"""

from __future__ import annotations

import json
import logging
import os
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from ag2video_torch.data.png import read_frame
from ag2video_torch.data.transforms import clip_transform
from ag2video_torch.vocab import cater_vocab

log = logging.getLogger(__name__)

# Fixed camera matrix from CATER's image_generation/render_videos (the
# static-camera case); reference data/cater.py:342-346. Dataset constant.
CATER_CAM = np.array([
    (1.4503, 1.6376, 0.0000, -0.0251),
    (-1.0346, 0.9163, 2.5685, 0.0095),
    (-0.6606, 0.5850, -0.4748, 10.5666),
    (-0.6592, 0.5839, -0.4738, 10.7452),
], np.float64)

# Per-(shape, size) 2D half-extents in source pixels (W=320, H=240);
# reference data/cater.py:260-316. (w_half, h_above_center, h_below_center).
BOX_EXTENTS = {
    ("spl", "large"): (35, 35, 35), ("spl", "medium"): (25, 25, 25),
    ("spl", "small"): (15, 15, 15),
    ("cylinder", "large"): (35, 35, 35), ("cylinder", "medium"): (25, 25, 25),
    ("cylinder", "small"): (15, 15, 15),
    ("cone", "large"): (35, 25, 40), ("cone", "medium"): (25, 15, 30),
    ("cone", "small"): (20, 20, 20),
    ("sphere", "large"): (35, 25, 40), ("sphere", "medium"): (25, 25, 25),
    ("sphere", "small"): (15, 15, 15),
    ("cube", "large"): (35, 35, 35), ("cube", "medium"): (25, 25, 25),
    ("cube", "small"): (15, 15, 15),
}

SOURCE_W, SOURCE_H = 320, 240
MIN_ACTION_FRAMES = 12  # reference cater.py:194-195

# Corrupt videos excluded upstream (reference cater.py:84-86).
CORRUPT_VIDEOS = frozenset([
    "CATER_new_004798", "CATER_new_006532", "CATER_new_001175",
    "CATER_new_000434", "CATER_new_000346",
])


def project_3d_points(pts: np.ndarray) -> np.ndarray:
    """Nx3 world points -> Nx2 in [-1, 1] screen coords, y negated so low Y
    is at the top (reference _project_3d_point, cater.py:332-354)."""
    homo = np.hstack([pts, np.ones((pts.shape[0], 1))])
    p = (CATER_CAM @ homo.T).T
    x = p[:, 0] / p[:, 3]
    y = p[:, 1] / -p[:, 3]
    return np.stack([x, y], axis=-1)


def boxes_from_scene(scene: Dict) -> np.ndarray:
    """All-frame boxes for every object + the dummy, normalized xywh
    (reference extract_bounding_boxes, cater.py:240-330)."""
    per_obj = []
    n_frames = None
    for obj in scene["objects"]:
        locs = np.array([v for _, v in obj["locations"].items()], np.float64)
        n_frames = locs.shape[0]
        p2 = project_3d_points(locs)
        cx = (p2[:, 0] + 1) * SOURCE_W / 2
        cy = (p2[:, 1] + 1) * SOURCE_H / 2
        w_half, h_up, h_down = BOX_EXTENTS[(obj["shape"], obj["size"])]
        x0 = (cx - w_half) / SOURCE_W
        y0 = (cy - h_up) / SOURCE_H
        w = (2 * w_half) / SOURCE_W
        h = (h_up + h_down) / SOURCE_H
        per_obj.append(np.stack([x0, y0, np.full_like(x0, w),
                                 np.full_like(y0, h)], axis=-1))
    dummy = np.tile(np.array([[0.0, 0.0, 1.0, 1.0]]), (n_frames, 1))
    per_obj.append(dummy)
    return np.stack(per_obj, axis=1).astype(np.float32)  # (F, O+1, 4)


def scene_actions(scene: Dict, vocab: Dict) -> np.ndarray:
    """[o1, action_idx, o2, frame_s, frame_t] rows, actions >= 12 frames
    (reference extract_actions_split collection, cater.py:180-209)."""
    name_to_ind = {o["instance"]: i for i, o in enumerate(scene["objects"])}
    rows = []
    for o1_name, movements in scene["movements"].items():
        o1 = name_to_ind[o1_name]
        for action, o2_name, f_s, f_t in movements:
            if f_t - f_s < MIN_ACTION_FRAMES:
                continue
            o2 = name_to_ind[o2_name] if o2_name is not None else o1
            rows.append([o1, vocab["action_name_to_idx"][action], o2, f_s, f_t])
    return np.array(rows, np.int64).reshape(-1, 5)


def normalize_actions(actions: np.ndarray, all_boxes: np.ndarray,
                      s_frame: int, e_frame: int, vocab: Dict) -> np.ndarray:
    """[o1, a, o2, f_s, f_t] -> [o1, a, o2, t1, t2, x_end, y_end] with
    clip-relative progress; GT end-position for _slide/_pick_place
    (reference normalized_actions, cater.py:446-466)."""
    if actions.size == 0:
        return np.zeros((0, 7), np.float32)
    f1 = actions[:, 3].astype(np.float32)
    f2 = actions[:, 4].astype(np.float32)
    t1 = (s_frame - f1) / (f2 - f1 + 1)
    t2 = (e_frame - f1) / (f2 - f1 + 1)
    keep = ~((t1 > 1) | (t2 < 0))
    out = np.concatenate(
        [actions[:, :3].astype(np.float32),
         np.stack([t1, t2], axis=-1)], axis=-1)[keep]
    kept = actions[keep]
    end_pos = all_boxes[kept[:, 4], kept[:, 0], :2].astype(np.float32)
    moved = np.isin(kept[:, 1],
                    [vocab["action_name_to_idx"]["_pick_place"],
                     vocab["action_name_to_idx"]["_slide"]])
    end_pos[~moved] = 0.0
    return np.concatenate([out, end_pos], axis=-1).astype(np.float32)


class CATERDataset:
    def __init__(
        self,
        split_file: str,
        data_root: str,
        image_size: Tuple[int, int] = (64, 64),
        frames_per_action: int = 16,
        initial_frames_per_sample: int = 48,
        is_val: bool = False,
        is_test: bool = False,
        max_samples: Optional[int] = None,
        include_relationships: bool = True,
        resize_or_crop: str = "resize",
        no_flip: bool = True,
        nframes: int = 301,
        fps: int = 24,
        seed: int = 0,
    ):
        self.data_root = data_root
        self.videos_path = os.path.join(data_root, "videos")
        self.scenes_path = os.path.join(data_root, "scenes")
        self.image_size = image_size
        self.frames_per_action = frames_per_action
        self.initial_frames_per_sample = initial_frames_per_sample
        self.is_val = is_val
        self.is_test = is_test
        self.nframes = nframes
        self.fps = fps
        self.resize_or_crop = resize_or_crop
        self.no_flip = no_flip
        self.seed = seed
        self.vocab = cater_vocab()

        available = {v.split(".")[0] for v in os.listdir(self.videos_path)} \
            if os.path.isdir(self.videos_path) else set()
        self.vid_names: List[str] = []
        with open(split_file) as f:
            for line in f:
                name = line.strip().split(" ")[0].split(".")[0]
                if not name or name in CORRUPT_VIDEOS:
                    continue
                if available and name not in available:
                    continue
                self.vid_names.append(name)
        if max_samples is not None:
            self.vid_names = self.vid_names[:max_samples]
        self._scene_cache: Dict[str, Dict] = {}

    @classmethod
    def from_config(cls, partition: str, cfg):
        """Partition windowing per the reference registry
        (data/dataset_params.py:152-185)."""
        data_root = os.environ.get(
            "CATER_DATA_ROOT",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "CATER", "max2action"))
        splits_dir = os.environ.get(
            "CATER_SPLITS_DIR",
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "CATER"))
        # Frame count per video: 301 for the max2action release (reference
        # cater.py:61); overridable for re-renders / truncated variants.
        nframes = int(os.environ.get("CATER_NFRAMES", "301"))
        table = {
            "train": dict(split="train.txt",
                          frames=cfg.frames_per_action,
                          initial=3 * cfg.frames_per_action),
            "train_graph": dict(split="train.txt",
                                frames=4 * cfg.frames_per_action_graph,
                                initial=4 * 3 * cfg.frames_per_action_graph),
            "val": dict(split="val_split.txt", frames=16, initial=16 * 3,
                        is_val=True),
            "test": dict(split="test_split.txt", frames=16, initial=16 * 3,
                         is_val=True, is_test=True),
        }[partition]
        return cls(
            split_file=os.path.join(splits_dir, table["split"]),
            data_root=data_root,
            image_size=cfg.image_size,
            frames_per_action=table["frames"],
            initial_frames_per_sample=table["initial"],
            is_val=table.get("is_val", False),
            is_test=table.get("is_test", False),
            resize_or_crop=cfg.resize_or_crop
            if hasattr(cfg, "resize_or_crop") else "resize",
            nframes=nframes,
            seed=cfg.seed,
        )

    def __len__(self) -> int:
        return len(self.vid_names)

    # ------------------------------------------------------------------
    def _scene(self, video_id: str) -> Dict:
        if video_id not in self._scene_cache:
            with open(os.path.join(self.scenes_path, f"{video_id}.json")) as f:
                self._scene_cache[video_id] = json.load(f)
        return self._scene_cache[video_id]

    def extract_frames(self, video_id: str) -> Optional[np.ndarray]:
        """Decode once into videos/<id>/%05d.png; return sorted paths
        (reference extract_frames, cater.py:421-444)."""
        cache = os.path.join(self.videos_path, video_id)
        if not os.path.isdir(cache):
            try:
                import cv2

                os.makedirs(cache, exist_ok=True)
                cap = cv2.VideoCapture(
                    os.path.join(self.videos_path, f"{video_id}.avi"))
                i = 0
                while i < self.nframes:
                    ok, frame = cap.read()
                    if not ok:
                        break
                    cv2.imwrite(os.path.join(cache, f"{i:05}.png"), frame)
                    i += 1
                cap.release()
            except Exception as e:
                log.warning("decode failed for %s: %s", video_id, e)
                return None
        paths = sorted(glob(os.path.join(cache, "*.png")))
        if len(paths) != self.nframes:
            log.warning("video %s has %d frames (expected %d)",
                        video_id, len(paths), self.nframes)
            return None
        return np.array(paths)

    def choose_window(self, actions: np.ndarray, max_frame: int,
                      rng: np.random.RandomState) -> Tuple[np.ndarray, int, int]:
        """Pick a window covering >=1 action; earliest at test
        (reference extract_actions_split, cater.py:180-209)."""
        start_frames = actions[:, 3]
        end_frames = actions[:, 4]
        span = self.initial_frames_per_sample
        if self.is_test:
            s = int(start_frames.min())
            e = int(min(end_frames.max(), s + span))
        else:
            hi = min(int(end_frames.max()), max_frame) - span + 1
            s = int(rng.randint(0, max(hi, 1)))
            e = s + span
        keep = ~((actions[:, 3] > e) | (actions[:, 4] < s))
        return actions[keep], s, e

    def extract_triplets(self, F: int, O: int) -> np.ndarray:
        """Trivial __in_image__ triplets only (reference cater.py:165-178)."""
        in_image = self.vocab["pred_name_to_idx"]["__in_image__"]
        one = np.array([[i, in_image, O] for i in range(O)], np.int64)
        return np.tile(one[None], (F, 1, 1))

    def extract_objs(self, scene: Dict) -> Dict[str, np.ndarray]:
        objs = {}
        for attr, table in self.vocab["attributes"].items():
            vals = [table[o[attr]] for o in scene["objects"]]
            vals.append(table["__image__"])
            objs[attr] = np.array(vals, np.int64)
        return objs

    # ------------------------------------------------------------------
    def __getitem__(self, index: int):
        video_id = self.vid_names[index]
        rng = np.random.RandomState(
            None if not (self.is_val or self.is_test)
            else self.seed + index)
        try:
            scene = self._scene(video_id)
            img_paths = self.extract_frames(video_id)
            if img_paths is None:
                return (None,) * 6

            all_actions = scene_actions(scene, self.vocab)
            if all_actions.size == 0:
                return (None,) * 6
            actions, s_frame, e_frame = self.choose_window(
                all_actions, len(img_paths) - 1, rng)

            frames_lst = list(range(s_frame, e_frame))
            stride = self.initial_frames_per_sample // self.frames_per_action
            frames_lst = frames_lst[0:self.initial_frames_per_sample:stride]
            # Test windows can end early (e = min(end_of_actions, s + span),
            # choose_window): repeat-pad the last frame so every sample has
            # exactly frames_per_action frames (ragged clips cannot stack in
            # the fixed-shape collate; the smth pipeline pads the same way,
            # reference smth.py:328-331).
            if len(frames_lst) < self.frames_per_action:
                frames_lst += frames_lst[-1:] * (
                    self.frames_per_action - len(frames_lst))

            frames = [read_frame(p) for p in
                      np.asarray(img_paths)[frames_lst]]
            vids = clip_transform(
                frames, self.image_size, self.resize_or_crop,
                train=not (self.is_val or self.is_test),
                no_flip=self.no_flip, rng=rng)

            all_boxes = boxes_from_scene(scene)
            boxes = all_boxes[frames_lst]
            triplets = self.extract_triplets(len(frames_lst),
                                             boxes.shape[1] - 1)
            objs = self.extract_objs(scene)
            norm_actions = normalize_actions(
                actions, all_boxes, s_frame, e_frame, self.vocab)
            return (vids, objs, boxes, triplets, norm_actions,
                    f"{video_id}_{s_frame}-{e_frame}")
        except Exception as e:
            log.warning("failed to load %s: %s", video_id, e)
            return (None,) * 6

    # ------------------------------------------------------------------
    def cache_all(self, num_workers: int = 1, worker_id: int = 0) -> None:
        """Pre-warm the PNG cache over a 1/num_workers shard (the
        reference's --cache_data mode, scripts/train.py:328-343)."""
        num_workers = max(num_workers, 1)
        shard = len(self) // num_workers
        lo = worker_id * shard
        hi = len(self) if worker_id == num_workers - 1 else lo + shard
        for i in range(lo, min(hi, len(self))):
            self.extract_frames(self.vid_names[i])
