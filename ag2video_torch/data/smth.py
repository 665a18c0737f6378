"""Something-Something V2 / "Something's Else" dataset (port of
ag2video_tpu/data/smth.py; reference data/smth.py:19-390).

Real videos with per-frame box annotations (boxes.pkl per video), labels
CSV filtered to the 8 templates with known object counts, geometric spatial
triplets derived from box arithmetic, and hand->object action chains. Bad
samples return (False, reason) tuples which the loader filters (reference
smth.py:299-358, dataset_params.py:30).

The port reads the label CSVs with the standard library's `csv` module
(`read_labels`), not pandas, and keeps exactly the rows that pandas' reader
and the JAX loader's filters keep: pandas' null tokens, its per-column
types (an all-integer column is int, so `id` enters paths as `str(id)`), the
`template` and `nr_instances` filters, and the `placeholders` lists read by
`ast.literal_eval` in place of `eval`. The frames are JPEGs, which the port
reads through PIL (data/png.py `read_frame`, imported when called), so this
loader needs PIL wherever it runs; the CATER loader does not. The CSVs in
SomethingElse/ are byte-for-byte copies of the JAX package's.
"""

from __future__ import annotations

import ast
import csv
import json
import logging
import math
import os
import pickle
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ag2video_torch.data.png import read_frame
from ag2video_torch.data.transforms import clip_transform
from ag2video_torch.vocab import SMTH_ACTION_NUM_OBJECTS, smth_else_vocab

log = logging.getLogger(__name__)

# The cells pandas.read_csv reads as null by default
# (pandas._libs.parsers.STR_NA_VALUES).
NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?"
                    r"|inf|Inf|INF|infinity|Infinity)\s*")


def isnull(value: Any) -> bool:
    """pandas.isnull of one cell read by `read_labels`."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def _typed(cells: List[Optional[str]]) -> List[Any]:
    """One column's cells typed as pandas types them: int when every cell is
    an integer, float when every cell is a number or null (null: nan),
    else str (null: None)."""
    present = [c for c in cells if c is not None]
    if present and len(present) == len(cells) and \
            all(_INT.fullmatch(c) for c in present):
        return [int(c) for c in cells]
    if present and all(_FLOAT.fullmatch(c) for c in present):
        return [math.nan if c is None else float(c) for c in cells]
    return cells


def read_labels(path: str) -> Tuple[List[str], List[Dict[str, Any]]]:
    """A labels CSV -> (its column names, its rows as {column: cell}), with
    pandas.read_csv's null cells and column types."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    columns = {}
    for j, name in enumerate(header):
        cells = [r[j] if j < len(r) else None for r in body]
        columns[name] = _typed([None if c is None or c in NA_VALUES else c
                                for c in cells])
    return header, [{name: columns[name][i] for name in header}
                    for i in range(len(body))]


def geometric_predicate(sbox: np.ndarray, obox: np.ndarray) -> str:
    """Spatial relation from xyxy boxes (reference extract_triplets,
    smth.py:151-176): containment else octant of the center offset."""
    sx0, sy0, sx1, sy1 = sbox
    ox0, oy0, ox1, oy1 = obox
    mean_x = (sx0 + 0.5 * (sx1 - sx0)) - (ox0 + 0.5 * (ox1 - ox0))
    mean_y = (sy0 + 0.5 * (sy1 - sy0)) - (oy0 + 0.5 * (oy1 - oy0))
    theta = math.atan2(mean_y, mean_x)
    if sx0 < ox0 and sx1 > ox1 and sy0 < oy0 and sy1 > oy1:
        return "surrounding"
    if sx0 > ox0 and sx1 < ox1 and sy0 > oy0 and sy1 < oy1:
        return "inside"
    if theta >= 3 * math.pi / 4 or theta <= -3 * math.pi / 4:
        return "left"
    if -3 * math.pi / 4 <= theta < -math.pi / 4:
        return "above"
    if -math.pi / 4 <= theta < math.pi / 4:
        return "right"
    return "below"


def dedupe_boxes_metadata(boxes_metadata: List[Dict]) -> List[Dict]:
    """Keep the first entry per frame name (reference clean_boxes_metadata,
    smth.py:378-390)."""
    seen = set()
    out = []
    for b in boxes_metadata:
        if b["name"] not in seen:
            seen.add(b["name"])
            out.append(b)
    return out


class SmthElseDataset:
    def __init__(
        self,
        labels_csv: str,
        data_root: str,
        image_size: Tuple[int, int] = (64, 64),
        frames_per_action: int = 16,
        initial_frames_per_sample: int = 16,
        is_val: bool = False,
        is_test: bool = False,
        max_samples: Optional[int] = None,
        include_relationships: bool = True,
        resize_or_crop: str = "resize",
        no_flip: bool = True,
        seed: int = 0,
    ):
        self.data_root = data_root
        self.image_size = image_size
        self.frames_per_action = frames_per_action
        self.initial_frames_per_sample = initial_frames_per_sample
        self.is_val = is_val
        self.is_test = is_test
        self.include_relationships = include_relationships
        self.resize_or_crop = resize_or_crop
        self.no_flip = no_flip
        self.seed = seed

        columns, labels = read_labels(labels_csv)
        if "err" in columns:
            labels = [r for r in labels if isnull(r["err"])]

        # Object-name mapping ships with the dataset
        # (offical_release_boxes/objs_mapping.json [sic], smth.py:99-101).
        mapping_path = os.path.join(
            data_root, "offical_release_boxes", "objs_mapping.json")
        if os.path.exists(mapping_path):
            with open(mapping_path) as f:
                self.objs_mapping = json.load(f)
        else:
            self.objs_mapping = {}
        self.vocab = smth_else_vocab(
            list(self.objs_mapping.values()) or None)

        # Filter: valid templates with matching instance counts and fully
        # mapped placeholder objects (smth.py:107-112, 365-375).
        labels = [r for r in labels
                  if r["template"] in SMTH_ACTION_NUM_OBJECTS]
        labels = [r for r in labels
                  if SMTH_ACTION_NUM_OBJECTS[r["template"]]
                  == r["nr_instances"]]
        if self.objs_mapping:
            def mapped_ok(r):
                try:
                    # The CSV stores a list repr.
                    objs = ast.literal_eval(r["placeholders"])
                except (ValueError, TypeError, SyntaxError, MemoryError,
                        RecursionError):
                    return False
                return all(o in self.objs_mapping for o in objs)
            labels = [r for r in labels if mapped_ok(r)]

        self.labels = labels
        self._rows: Dict[Any, Dict[str, Any]] = {}
        for r in labels:
            self._rows.setdefault(r["id"], r)
        self.vid_names = [r["id"] for r in labels]
        if max_samples is not None:
            self.vid_names = self.vid_names[:max_samples]

    @classmethod
    def from_config(cls, partition: str, cfg):
        """Partition scheme per the reference registry
        (data/dataset_params.py:117-150)."""
        data_root = os.environ.get(
            "SMTH_DATA_ROOT",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "SomethingElse"))
        splits_dir = os.environ.get("SMTH_SPLITS_DIR", data_root)
        table = {
            "train": dict(csv="train.csv", frames=cfg.frames_per_action,
                          initial=cfg.frames_per_action),
            "train_graph": dict(csv="train.csv",
                                frames=4 * cfg.frames_per_action_graph,
                                initial=4 * cfg.frames_per_action_graph),
            "val": dict(csv="val_split.csv", frames=16, initial=16,
                        is_val=True),
            "test": dict(csv="test_split.csv", frames=16, initial=16,
                         is_val=True, is_test=True),
        }[partition]
        return cls(
            labels_csv=os.path.join(splits_dir, table["csv"]),
            data_root=data_root,
            image_size=cfg.image_size,
            frames_per_action=table["frames"],
            initial_frames_per_sample=table["initial"],
            is_val=table.get("is_val", False),
            is_test=table.get("is_test", False),
            seed=cfg.seed,
        )

    def __len__(self) -> int:
        return len(self.vid_names)

    # ------------------------------------------------------------------
    def extract_triplets(self, boxes_xywh: np.ndarray,
                         rng: np.random.RandomState) -> np.ndarray:
        """Per-frame: one random geometric relation per object + trivial
        __in_image__ rows (reference smth.py:134-186). boxes: (F, O+1, 4)."""
        F, Op1, _ = boxes_xywh.shape
        O = Op1 - 1
        in_image = self.vocab["pred_name_to_idx"]["__in_image__"]
        out = []
        for f in range(F):
            rows = []
            if self.include_relationships and O > 1:
                for cur in range(O):
                    other = rng.choice([o for o in range(O) if o != cur])
                    s, o = (cur, other) if rng.rand() > 0.5 else (other, cur)
                    sb = boxes_xywh[f, s].copy()
                    ob = boxes_xywh[f, o].copy()
                    sb[2:] += sb[:2]
                    ob[2:] += ob[:2]
                    p = self.vocab["pred_name_to_idx"][
                        geometric_predicate(sb, ob)]
                    rows.append([s, p, o])
            for i in range(O):
                rows.append([i, in_image, O])
            out.append(rows)
        return np.array(out, np.int64)

    def extract_actions(self, obj_ids: np.ndarray, action_idx: int,
                        t1: float, t2: float):
        """Hand -> object action chain; last object must be 'hand'
        (reference smth.py:204-222)."""
        names = self.vocab["reverse_attributes"]["object"]
        hand_idx = len(obj_ids) - 1
        if names[int(obj_ids[hand_idx])] != "hand":
            return False, "Last index is not hand"
        rows = []
        prev = hand_idx
        for i in range(hand_idx):
            if names[int(obj_ids[i])] == "hand":
                return False, "Multiple indices are hand"
            rows.append([prev, action_idx, i, t1, t2, 0.0, 0.0])
            prev = i
        if not rows:
            return False, "No returned triplets"
        return True, np.array(rows, np.float32)

    def extract_bounding_boxes(self, boxes_metadata: List[Dict],
                               img_shape: Tuple[int, int], num_objects: int):
        """Annotation boxes with carry-forward for missing frames
        (reference smth.py:224-261)."""
        object_indices: Dict[tuple, int] = {}
        for ts in boxes_metadata:
            for obj in ts["labels"]:
                key = (obj["standard_category"], obj["gt_annotation"],
                       self.objs_mapping.get(obj["category"],
                                             obj["category"]))
                if key not in object_indices:
                    object_indices[key] = len(object_indices)

        F = len(boxes_metadata)
        out = np.zeros((F, num_objects, 4), np.float64)
        for i, ts in enumerate(boxes_metadata):
            if i > 0:
                out[i] = out[i - 1]  # carry forward
            for obj in ts["labels"]:
                b = obj["box2d"]
                x1, x2, y1, y2 = b["x1"], b["x2"], b["y1"], b["y2"]
                if x1 == x2 and y1 == y2:
                    x1 = x2 = y1 = y2 = 0.0
                key = (obj["standard_category"], obj["gt_annotation"],
                       self.objs_mapping.get(obj["category"],
                                             obj["category"]))
                idx = object_indices[key]
                if idx < num_objects:
                    out[i, idx] = [x1, y1, x2 - x1, y2 - y1]

        if len(object_indices) != num_objects:
            return False, "len(objects) != num_objects", None
        W, H = img_shape
        out = out / np.array([W, H, W, H], np.float64)
        rev = {v: k for k, v in object_indices.items()}
        table = self.vocab["attributes"]["object"]
        obj_ids = np.array([table.get(rev[i][-1], 0)
                            for i in range(num_objects)], np.int64)
        return True, out.astype(np.float32), obj_ids

    def choose_window(self, boxes_metadata: List[Dict], num_objects: int,
                      rng: np.random.RandomState):
        """Window over the frames where all objects are present, with
        action progress at window edges (reference smth.py:188-202)."""
        nr = np.array([b["nr_instances"] for b in boxes_metadata])
        idx = np.where(nr == num_objects)[0]
        if idx.size == 0:
            return None
        s_frame, e_frame = int(idx.min()), int(idx.max()) + 1
        span = self.initial_frames_per_sample
        if self.is_test:
            f1, f2 = s_frame, s_frame + span
        else:
            f1 = s_frame
            if e_frame - span > s_frame:
                f1 = int(rng.randint(s_frame, e_frame - span))
            f2 = min(f1 + span, e_frame)
        t1 = (f1 - s_frame + 1) / (e_frame - s_frame)
        t2 = (f2 - s_frame + 1) / (e_frame - s_frame)
        return f1, f2, t1, t2

    # ------------------------------------------------------------------
    def __getitem__(self, index: int):
        video_id = self.vid_names[index]
        rng = np.random.RandomState(
            self.seed + index if (self.is_val or self.is_test) else None)
        try:
            boxes_path = os.path.join(
                self.data_root, "offical_release_boxes", "boxes_by_video_id",
                str(video_id), "boxes.pkl")
            with open(boxes_path, "rb") as f:
                boxes_metadata = dedupe_boxes_metadata(pickle.load(f))

            row = self._rows[video_id]
            action_name = row["template"]
            action_idx = self.vocab["action_name_to_idx"][action_name]
            num_objects = SMTH_ACTION_NUM_OBJECTS[action_name]

            win = self.choose_window(boxes_metadata, num_objects, rng)
            if win is None:
                return False, "Mixed number of objects (occlusion?)"
            f1, f2, prog_s, prog_e = win
            thr = min(self.initial_frames_per_sample, 8)
            if not self.is_val and (f2 - f1) < thr:
                return False, f"window shorter than {thr}"

            frames_lst = list(range(f1, f2))
            meta = boxes_metadata[f1:f2]
            if self.is_test:
                fpa = init = len(frames_lst)
            else:
                fpa = self.frames_per_action
                init = self.initial_frames_per_sample
            stride = max(init // fpa, 1)
            frames_lst = frames_lst[0:init:stride]
            meta = meta[0:init:stride]
            if len(frames_lst) < fpa:  # repeat-pad short clips
                pad = fpa - len(frames_lst)
                frames_lst += frames_lst[-1:] * pad
                meta += meta[-1:] * pad

            paths = sorted(os.path.join(self.data_root, "frames", b["name"])
                           for b in boxes_metadata)
            first = read_frame(paths[0])
            status, boxes, obj_ids = self.extract_bounding_boxes(
                meta, (first.shape[1], first.shape[0]), num_objects)
            if not status:
                return False, boxes

            status, actions = self.extract_actions(
                obj_ids, action_idx, prog_s, prog_e)
            if not status:
                return False, actions

            # Dummy whole-image object.
            boxes = np.concatenate(
                [boxes, np.tile([[0, 0, 1, 1]], (boxes.shape[0], 1, 1))],
                axis=1).astype(np.float32)
            obj_arr = {"object": np.concatenate([obj_ids, [0]])}

            triplets = self.extract_triplets(boxes, rng)
            frames = [read_frame(np.asarray(paths)[i]) for i in frames_lst]
            vids = clip_transform(
                frames, self.image_size, self.resize_or_crop,
                train=not (self.is_val or self.is_test),
                no_flip=self.no_flip, rng=rng)
            return (vids, obj_arr, boxes, triplets, actions,
                    f"{video_id}_{f1}-{f2}")
        except Exception as e:
            return False, f"Error in video_id {video_id}: {e}"
