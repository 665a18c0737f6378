"""Fixed-shape collation (a copy of ag2video_tpu/data/collate.py, held
equal to it by tests/test_torch_copies.py; pure numpy).

The reference pads to per-batch maxima (data/dataset_params.py:8-104);
XLA needs static shapes, so samples are padded to the Config caps with the
reference's padding values: objs -> 0, boxes -> [-1,-1,-1,-1], triplets ->
[0, __padding__pred, 0], actions -> [0, __padding__action, 0, 0, 0, 0, 0].
Samples exceeding a cap are truncated with a warning (caps should be set
from dataset statistics).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Sequence

import numpy as np

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Batch:
    """A fixed-shape training batch (all numpy/jax arrays)."""

    imgs: Any       # (B, T, H, W, 3) float32
    objs: Any       # (B, O, A) int32
    boxes: Any      # (B, T, O, 4) float32
    triplets: Any   # (B, T, E, 3) int32
    actions: Any    # (B, A_act, 7) float32
    video_ids: List[str]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "imgs": self.imgs, "objs": self.objs, "boxes": self.boxes,
            "triplets": self.triplets, "actions": self.actions,
        }


def collate(
    samples: Sequence[tuple],
    vocab: Dict[str, Any],
    max_objects: int,
    max_triplets: int,
    max_actions: int,
) -> Batch:
    """samples: list of (vids, objs{family: (O,)}, boxes (T,O,4),
    triplets (T,E,3), actions (A,7), video_id)."""
    pad_pred = vocab["pred_name_to_idx"]["__padding__"]
    pad_act = vocab["action_name_to_idx"]["__padding__"]
    families = list(vocab["attributes"])

    imgs_l, objs_l, boxes_l, trip_l, act_l, ids = [], [], [], [], [], []
    for vids, objs, boxes, triplets, actions, video_id in samples:
        O = len(objs[families[0]])
        T = boxes.shape[0]
        E = triplets.shape[1]
        A = actions.shape[0] if actions.size else 0

        if O > max_objects:
            # Truncating objects would drop the dummy __image__ row (always
            # last) and leave triplets pointing at out-of-cap indices —
            # semantic corruption, not truncation. Skip the sample; caps
            # must be set from dataset statistics.
            log.warning("sample %s has O=%d > max_objects=%d; skipping",
                        video_id, O, max_objects)
            continue
        if E > max_triplets or A > max_actions:
            log.warning(
                "sample %s exceeds caps (E=%d A=%d); truncating edges",
                video_id, E, A)
            E = min(E, max_triplets)
            A = min(A, max_actions)

        obj_arr = np.zeros((max_objects, len(families)), np.int32)
        for k, fam in enumerate(families):
            obj_arr[:O, k] = np.asarray(objs[fam][:O])

        box_arr = np.full((T, max_objects, 4), -1.0, np.float32)
        box_arr[:, :O] = boxes[:, :O]

        trip_arr = np.zeros((T, max_triplets, 3), np.int32)
        trip_arr[..., 1] = pad_pred
        trip_arr[:, :E] = triplets[:, :E]

        act_arr = np.zeros((max_actions, 7), np.float32)
        act_arr[:, 1] = pad_act
        if A:
            act_arr[:A] = actions[:A]

        imgs_l.append(np.asarray(vids, np.float32))
        objs_l.append(obj_arr)
        boxes_l.append(box_arr)
        trip_l.append(trip_arr)
        act_l.append(act_arr)
        ids.append(video_id)

    return Batch(
        imgs=np.stack(imgs_l),
        objs=np.stack(objs_l),
        boxes=np.stack(boxes_l),
        triplets=np.stack(trip_l),
        actions=np.stack(act_l),
        video_ids=ids,
    )
