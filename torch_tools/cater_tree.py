"""Fabricate a CATER max2action tree with no PIL and no cv2.

    python3 torch_tools/cater_tree.py <dir> [--videos 6] [--nframes 301]

writes `<dir>/max2action/{scenes,videos}` and `<dir>/splits/{train,
val_split,test_split}.txt` (every video in each split), the layout that
`ag2video_torch.data.cater.CATERDataset.from_config` reads with
`CATER_DATA_ROOT=<dir>/max2action CATER_SPLITS_DIR=<dir>/splits`. Each
video has a scene JSON with objects drawn from the CATER vocabulary (shape,
colour, material, size) moving on 3-D paths, `movements` that hold actions
of 12 frames or more (and one shorter one, which the loader skips), its
frame cache as PNGs written by `ag2video_torch.data.png.write_png` (flat
rectangles at the projected boxes on a gray floor, at CATER's 320x240 by
default) and an empty `.avi`, as the JAX package's tests fabricate it.
`chip_smoke.py` phase 11 and tests/test_torch_cli.py train on such trees.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ag2video_torch.data.cater import (  # noqa: E402
    SOURCE_H, SOURCE_W, boxes_from_scene)
from ag2video_torch.data.png import write_png  # noqa: E402
from ag2video_torch.vocab import cater_vocab  # noqa: E402

# Flat colours of the CATER colour names, RGB.
COLOURS = {"gray": (128, 128, 128), "red": (173, 35, 35),
           "blue": (42, 75, 215), "green": (29, 105, 20),
           "brown": (129, 74, 25), "purple": (129, 38, 192),
           "cyan": (41, 208, 208), "yellow": (255, 238, 51),
           "gold": (212, 175, 55)}
FLOOR = (96, 96, 96)


def make_scene(rng: np.random.RandomState, n_objects: int,
               nframes: int) -> dict:
    """A scene JSON: objects with per-frame 3-D locations and movements."""
    names = {k: [n for n in table if n != "__image__"]
             for k, table in cater_vocab()["attributes"].items()}
    objects = []
    for i in range(n_objects):
        start = rng.uniform(-2.5, 2.5, 2)
        end = rng.uniform(-2.5, 2.5, 2)
        ramp = np.clip((np.arange(nframes) - 20.0 * i) / nframes * 2, 0, 1)
        xy = start + ramp[:, None] * (end - start)
        objects.append({
            "instance": f"obj_{i}",
            **{k: str(rng.choice(v)) for k, v in names.items()},
            "locations": {str(t): [float(xy[t, 0]), float(xy[t, 1]), 0.5]
                          for t in range(nframes)},
        })
    last = nframes - 1
    movements = {
        "obj_0": [["_slide", None, 2, min(2 + 30, last)],
                  ["_rotate", None, 0, 5]],   # under 12 frames: skipped
        "obj_1": [["_contain", "obj_0", 10, min(40, last)]],
    }
    if n_objects > 2:
        movements["obj_2"] = [["_pick_place", None, min(20, last - 13),
                               min(50, last)]]
    return {"objects": objects, "movements": movements}


def render(scene: dict, boxes: np.ndarray,
           size: Tuple[int, int]) -> np.ndarray:
    """One frame from its (O + 1, 4) boxes (the last the whole-image dummy):
    the objects' boxes as flat rectangles, farthest first."""
    W, H = size
    img = np.empty((H, W, 3), np.uint8)
    img[:] = FLOOR
    boxes = boxes[:-1]
    order = np.argsort(boxes[:, 1] + boxes[:, 3])   # lower edge: nearer
    for o in order:
        x0, y0, w, h = boxes[o]
        xa, xb = (int(np.clip(v * W, 0, W)) for v in (x0, x0 + w))
        ya, yb = (int(np.clip(v * H, 0, H)) for v in (y0, y0 + h))
        img[ya:yb, xa:xb] = COLOURS[scene["objects"][o]["color"]]
    return img


def make_tree(out_dir: str, n_videos: int = 6, nframes: int = 301,
              n_objects: int = 5, size: Tuple[int, int] = (SOURCE_W,
                                                            SOURCE_H),
              seed: int = 0, threads: int = 8) -> Tuple[str, str, List[str]]:
    """Write the tree -> (data root, splits directory, video names)."""
    root = os.path.join(out_dir, "max2action")
    splits = os.path.join(out_dir, "splits")
    for d in ("scenes", "videos"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    os.makedirs(splits, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = [f"CATER_new_{k:06}" for k in range(n_videos)]
    with ThreadPoolExecutor(threads) as pool:
        for name in names:
            scene = make_scene(rng, n_objects, nframes)
            with open(os.path.join(root, "scenes", f"{name}.json"), "w") as f:
                json.dump(scene, f)
            cache = os.path.join(root, "videos", name)
            os.makedirs(cache, exist_ok=True)
            boxes = boxes_from_scene(scene)
            list(pool.map(lambda t: write_png(
                os.path.join(cache, f"{t:05}.png"),
                render(scene, boxes[t], size)), range(nframes)))
            open(os.path.join(root, "videos", f"{name}.avi"), "w").close()
    lines = "".join(f"{n}.avi 1,2\n" for n in names)
    for split in ("train.txt", "val_split.txt", "test_split.txt"):
        with open(os.path.join(splits, split), "w") as f:
            f.write(lines)
    return root, splits, names


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--videos", type=int, default=6)
    p.add_argument("--nframes", type=int, default=301)
    p.add_argument("--objects", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    root, splits, names = make_tree(args.out_dir, args.videos, args.nframes,
                                    args.objects, seed=args.seed)
    print(f"CATER_DATA_ROOT={root} CATER_SPLITS_DIR={splits} "
          f"CATER_NFRAMES={args.nframes} ({len(names)} videos)")


if __name__ == "__main__":
    main()
