"""Programmatic action construction — the compositionality API (a copy of
ag2video_tpu/inference/actions.py, held equal to it by
tests/test_torch_copies.py; pure numpy).

Actions are rows [subject_idx, action_idx, object_idx, t1, t2, x_end, y_end]
(reference scripts/test.py:49-147, data/cater.py:453-466). Zero-shot
composition = concatenating rows with overlapping/offset normalized time
windows; timing control = shifting (t1, t2):
  whole clip      -> (0, ~1)
  'before'-style  -> (0, k>1)  (action compressed into the clip's start)
  'after'-style   -> (t1<0, 1) (action begins before the clip)

The reference exposes these only as ad-hoc closures inside the test script;
here they are first-class, dataset-agnostic builders returning (A, 7)
float32 arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def action_rows(rows: Sequence[Sequence[float]]) -> np.ndarray:
    a = np.asarray(rows, np.float32).reshape(-1, 7)
    return a


def single(subject: int, action_idx: int, obj: Optional[int] = None,
           t1: float = 0.0, t2: float = 1.01,
           x_end: float = 0.0, y_end: float = 0.0) -> np.ndarray:
    """One action row (reference's up/down/left/right builders,
    test.py:48-98, use patterns like [1, a, 0, 0, 1.01, 0, 0])."""
    obj = subject if obj is None else obj
    return action_rows([[subject, action_idx, obj, t1, t2, x_end, y_end]])


def compose(*action_sets: np.ndarray) -> np.ndarray:
    """Concatenate independently-built actions — zero-shot composition."""
    return np.concatenate([np.asarray(a, np.float32) for a in action_sets],
                          axis=0)


def converge(num_objs: int, action_idx: int, target_obj: int = 0) -> np.ndarray:
    """All objects contain/approach object 0 with staggered starts
    (reference converge, test.py:101-111)."""
    rows = []
    for j in range(1, num_objs):
        start = float(j) / num_objs
        rows.append([j, action_idx, target_obj, start, 1.05, 0, 0])
    return action_rows(rows)


def converge_before(num_objs: int, action_idx: int,
                    target_obj: int = 0) -> np.ndarray:
    """Converge squeezed into the clip (reference test.py:114-121)."""
    rows = []
    for j in range(1, num_objs):
        start = -1.0 * (float(j) / num_objs)
        rows.append([j, action_idx, target_obj, start, 2.0, 0, 0])
    return action_rows(rows)


def converge_after(num_objs: int, action_idx: int,
                   target_obj: int = 0) -> np.ndarray:
    """Converge already mostly elapsed (reference test.py:124-134)."""
    rows = []
    for j in range(1, num_objs):
        start = -1.0 * (float(j) / num_objs) - 1.0
        rows.append([j, action_idx, target_obj, start, 1.05, 0, 0])
    return action_rows(rows)


def swap(boxes0: np.ndarray, idx1: int, idx2: int,
         action_idx_1: int, action_idx_2: int) -> np.ndarray:
    """Two objects trade positions via (x_end, y_end) targets
    (reference swap, test.py:137-147). boxes0: (O, 4) frame-0 boxes."""
    t1 = boxes0[idx2][:2]
    t2 = boxes0[idx1][:2]
    return action_rows([
        [idx1, action_idx_1, idx1, -0.3, 1.3, float(t1[0]), float(t1[1])],
        [idx2, action_idx_2, idx2, -0.3, 1.3, float(t2[0]), float(t2[1])],
    ])


def shift_before(actions: np.ndarray, stretch: float = 3.0) -> np.ndarray:
    """Timing variant: action happens early then holds
    (reference test.py:249-251 sets t1=0, t2=3)."""
    out = actions.copy()
    out[:, 3] = 0.0
    out[:, 4] = stretch
    return out


def shift_after(actions: np.ndarray, delay: float = 2.0) -> np.ndarray:
    """Timing variant: action already elapsed before the clip
    (reference test.py:263-265 sets t1=-2, t2=1)."""
    out = actions.copy()
    out[:, 3] = -delay
    out[:, 4] = 1.0
    return out


def extend_horizon(actions: np.ndarray, factor: float) -> np.ndarray:
    """Stretch windows so a T-frame rollout covers `factor` x the action —
    long-horizon generation uses t2 > 1 (reference test.py:251
    `norm_actions[:, :, 4] = 3.`)."""
    out = actions.copy()
    out[:, 4] = out[:, 4] * factor
    return out


def real_object_count(objs: np.ndarray) -> int:
    """Number of real objects in a padded (B, O, A) attribute tensor:
    slots with first-attribute id 0 are the dummy/padding (the reference
    works on unpadded objs and uses objs.shape[1] - 1, test.py:103)."""
    return int((np.asarray(objs)[0, :, 0] != 0).sum())


def cater_execute_set(vocab: Dict) -> List[Dict]:
    """The reference's CATER test-time action set (test.py:150-153).

    Builders receive the *padded* batch objs; the real object count is
    recovered from the attribute ids so padding slots never become action
    subjects."""
    contain = vocab["action_name_to_idx"]["_contain"]
    slide = vocab["action_name_to_idx"]["_slide"]
    pick = vocab["action_name_to_idx"]["_pick_place"]
    return [
        {"action_name": "converge",
         "action_func": lambda objs, vids, boxes:
             converge(real_object_count(objs), contain)},
        {"action_name": "swap",
         "action_func": lambda objs, vids, boxes:
             swap(np.asarray(boxes[0, 0]), 0, 1, pick, slide)},
    ]


ACTION_BUILDERS = {
    "single": single,
    "compose": compose,
    "converge": converge,
    "converge_before": converge_before,
    "converge_after": converge_after,
    "swap": swap,
    "shift_before": shift_before,
    "shift_after": shift_after,
    "extend_horizon": extend_horizon,
}
