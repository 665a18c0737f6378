"""Synthetic moving-shapes dataset (a copy of ag2video_tpu/data/synthetic.py,
held equal to it by tests/test_torch_data.py; pure numpy).

The reference advertises `--dataset synthetic` (data/args.py:23) but never
implements it; here it is the CPU-runnable CI and benchmark workload:
procedurally generated scenes of colored shapes whose boxes follow the
action semantics exactly (slide actions move an object linearly to
(x_end, y_end) over the action window), with frames rendered analytically —
so the graph->layout model has exact learnable dynamics and the
layout->video model has consistent pixels, with no data on disk.

Sample structure matches CATERDataset.__getitem__ (reference
data/cater.py:359-419): (vids (T,H,W,3) ImageNet-normalized float32,
objs {family: (O,) int}, boxes (T,O,4) xywh, triplets (T,E,3) int,
norm_actions (A,7) float [s, a, o, t1, t2, x_end, y_end], video_id), with
the whole-image dummy object appended (box [0,0,1,1], cater.py:327).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ag2video_torch.data.transforms import IMG_MEAN, IMG_STD
from ag2video_torch.vocab import synthetic_vocab

COLOR_RGB = {
    1: (0.85, 0.15, 0.15),  # red
    2: (0.15, 0.75, 0.20),  # green
    3: (0.20, 0.30, 0.90),  # blue
    4: (0.90, 0.85, 0.15),  # yellow
    5: (0.85, 0.20, 0.85),  # magenta
    6: (0.15, 0.85, 0.85),  # cyan
}
SIZE_EXTENT = {1: 0.10, 2: 0.18}  # small, large (box side, fraction of image)


class SyntheticDataset:
    """Deterministic per-index scenes; no I/O."""

    def __init__(
        self,
        partition: str = "train",
        image_size: Tuple[int, int] = (64, 64),
        frames_per_action: int = 4,
        dataset_size: int = 1000,
        number_of_objects: int = 5,
        seed: int = 0,
        max_actions: int = 2,
        dynamics: str = "linear",
        render: bool = True,
    ):
        if dynamics not in ("linear", "hard"):
            raise ValueError(f"unknown dynamics {dynamics!r}")
        self.partition = partition
        self.image_size = image_size
        self.frames = frames_per_action
        self.size = dataset_size
        self.num_objects = number_of_objects
        self.max_actions = max_actions
        self.dynamics = dynamics
        # Graph-only training never reads pixels; skipping the analytic
        # renderer removes the host-side bottleneck (the loss uses boxes
        # only — registry.py passes render=False for those loaders).
        self.render = render
        # Distinct index spaces per partition.
        self.seed = seed + {"train": 0, "train_graph": 0, "val": 10_000_000,
                            "test": 20_000_000}.get(partition, 0)
        self.vocab = synthetic_vocab()

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int):
        rng = np.random.RandomState(self.seed + index)
        F = self.frames
        O = self.num_objects
        v = self.vocab

        shapes = rng.randint(1, 4, O)
        colors = rng.randint(1, 7, O)
        sizes = rng.randint(1, 3, O)
        extents = np.array([SIZE_EXTENT[s] for s in sizes], np.float32)

        # Initial top-left corners, kept in frame.
        pos0 = rng.uniform(0.05, 0.95 - extents[:, None], (O, 2)).astype(np.float32)

        # Actions: slide K objects to random targets over sub-windows.
        hard = self.dynamics == "hard"
        n_act = rng.randint(1, self.max_actions + 1)
        subjects = rng.choice(O, size=n_act, replace=False)
        slide_idx = v["action_name_to_idx"]["_slide"]
        actions = []
        targets = {}
        windows = {}
        for s in subjects:
            x_end, y_end = rng.uniform(0.05, 0.75, 2).astype(np.float32)
            # Normalized action window: (t1, t2) such that progress
            # rel(t) = (t/F)*(t2 - t1) + t1 covers cases before/within clip.
            kind = rng.randint(0, 3)
            if kind == 0:
                t1, t2 = 0.0, 1.0            # spans the whole clip
            elif kind == 1:
                t1, t2 = 0.0, 2.0            # first half of the clip
            else:
                t1, t2 = -1.0, 1.0           # second half of the clip
            actions.append([float(s), float(slide_idx), float(s), t1, t2,
                            float(x_end), float(y_end)])
            targets[s] = np.array([x_end, y_end], np.float32)
            windows[s] = (t1, t2)

        # "hard" dynamics — deterministic functions of the *graph* that the
        # literal action-semantics rule cannot express:
        #   (1) relation-dependent motion: a free object per subject becomes
        #       a follower (triplet `(follower, follows, subject)`), rigidly
        #       translating with the subject;
        #   (2) distractor actions: a `_no_op` row with a tempting
        #       (x_end, y_end) that causes no motion;
        #   (3) curved trajectories: subjects move on a quadratic Bezier
        #       whose control-point offset is perpendicular to the chord,
        #       signed by shape (square +, disc -, diamond straight);
        #   (4) attribute-dependent easing: small objects accelerate
        #       (rel^2), large objects decelerate (1-(1-rel)^2).
        followers = {}                        # follower -> subject
        if hard:
            free = [o for o in range(O) if o not in targets]
            rng.shuffle(free)
            for s in subjects:
                if not free:
                    break
                followers[free.pop()] = int(s)
            if free and len(actions) < self.max_actions \
                    and rng.rand() < 0.5:
                d = free[0]
                dx, dy = rng.uniform(0.05, 0.75, 2)
                actions.append([float(d),
                                float(v["action_name_to_idx"]["_no_op"]),
                                float(d), 0.0, 1.0, float(dx), float(dy)])
        norm_actions = np.array(actions, np.float32)

        def subject_pos(o: int, t: int) -> np.ndarray:
            """Position of acted subject `o` at frame t (top-left corner)."""
            t1, t2 = windows[o]
            rel = (t / F) * (t2 - t1 + 1e-6) + t1
            rel = float(np.clip(rel, 0.0, 1.0))
            p0, p1 = pos0[o], targets[o]
            if not hard:
                return p0 * (1 - rel) + p1 * rel
            e = rel * rel if sizes[o] == 1 else 1.0 - (1.0 - rel) ** 2
            kappa = {1: 0.30, 2: -0.30, 3: 0.0}[int(shapes[o])]
            chord = p1 - p0
            ctrl = (p0 + p1) / 2 + kappa * np.array(
                [-chord[1], chord[0]], np.float32)
            return ((1 - e) ** 2 * p0 + 2 * e * (1 - e) * ctrl
                    + e * e * p1).astype(np.float32)

        # Box rollout following the action-clock semantics exactly
        # (progress rel(t) = (t/F)*(t2-t1+eps)+t1, clipped to [0,1]).
        boxes = np.zeros((F, O + 1, 4), np.float32)
        for t in range(F):
            for o in range(O):
                if o in targets:
                    p = subject_pos(o, t)
                elif o in followers:
                    s = followers[o]
                    p = pos0[o] + (subject_pos(s, t) - pos0[s])
                else:
                    p = pos0[o]
                boxes[t, o] = [p[0], p[1], extents[o], extents[o]]
            boxes[t, O] = [0.0, 0.0, 1.0, 1.0]  # dummy __image__ object

        # Trivial __in_image__ triplets (reference cater.py:165-178), plus
        # the `follows` relation edges under hard dynamics.
        in_image = v["pred_name_to_idx"]["__in_image__"]
        rows = [[o, in_image, O] for o in range(O)]
        if followers:
            follows = v["pred_name_to_idx"]["follows"]
            rows += [[f, follows, s] for f, s in sorted(followers.items())]
        triplets = np.array([rows for _ in range(F)], np.int64)

        objs: Dict[str, np.ndarray] = {
            "shape": np.concatenate([shapes, [0]]).astype(np.int64),
            "color": np.concatenate([colors, [0]]).astype(np.int64),
            "size": np.concatenate([sizes, [0]]).astype(np.int64),
        }

        if self.render:
            vids = self._render(boxes[:, :O], shapes, colors)
        else:
            H, W = self.image_size
            vids = np.broadcast_to(
                ((0.12 - IMG_MEAN) / IMG_STD).astype(np.float32),
                (F, H, W, 3)).copy()
        video_id = f"synthetic_{self.partition}_{index}"
        return vids, objs, boxes, triplets, norm_actions, video_id

    def _render(self, boxes: np.ndarray, shapes: np.ndarray,
                colors: np.ndarray) -> np.ndarray:
        """Draw shapes into frames; returns ImageNet-normalized (F,H,W,3)."""
        F, O, _ = boxes.shape
        H, W = self.image_size
        ys = (np.arange(H, dtype=np.float32) + 0.5) / H
        xs = (np.arange(W, dtype=np.float32) + 0.5) / W
        yy, xx = np.meshgrid(ys, xs, indexing="ij")

        frames = np.zeros((F, H, W, 3), np.float32)
        frames[..., :] = 0.12  # dark background
        for t in range(F):
            for o in range(O):
                x0, y0, w, h = boxes[t, o]
                cx, cy = x0 + w / 2, y0 + h / 2
                u = (xx - cx) / (w / 2 + 1e-8)
                vq = (yy - cy) / (h / 2 + 1e-8)
                if shapes[o] == 1:      # square
                    mask = (np.abs(u) <= 1) & (np.abs(vq) <= 1)
                elif shapes[o] == 2:    # disc
                    mask = u * u + vq * vq <= 1
                else:                   # diamond
                    mask = np.abs(u) + np.abs(vq) <= 1
                frames[t][mask] = COLOR_RGB[int(colors[o])]
        return (frames - IMG_MEAN) / IMG_STD
