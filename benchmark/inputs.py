"""Seeded model inputs: padded action graphs, first-frame boxes and frames.

The recipe of the program's synthetic inputs (random attributes for every
object but the last, the dummy; random spatial triplets per frame; actions
[subject, id, object, start, end, x_end, y_end]; boxes in [0.1, 0.5]; frames
N(0, 1)), copied here so that the program receives only arrays. Every shape
is the traffic's caps (B, T, O, E, A), so the device work does not depend on
the values, and every seed gives the same sizes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def make_batch(vocab: Dict[str, Any], traffic: Dict[str, Any],
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
    B, T = traffic["batch"], traffic["frames"]
    O, E, A = (traffic["max_objects"], traffic["max_triplets"],
               traffic["max_actions"])
    H, W = traffic["image_size"]
    n_attr = len(vocab["attributes"])
    objs = rng.integers(1, 3, (B, O, n_attr))
    objs[:, -1] = 0
    triplets = np.stack([rng.integers(0, O, (B, T, E)),
                         rng.integers(0, vocab["predicates"], (B, T, E)),
                         rng.integers(0, O, (B, T, E))], -1)
    actions = np.concatenate([rng.integers(0, O, (B, A, 1)),
                              rng.integers(1, 3, (B, A, 1)),
                              rng.integers(0, O, (B, A, 1)),
                              rng.uniform(-0.5, 0.5, (B, A, 2)),
                              rng.uniform(0, 1, (B, A, 2))],
                             -1).astype(np.float32)
    boxes = rng.uniform(0.1, 0.5, (B, T, O, 4)).astype(np.float32)
    imgs = rng.standard_normal((B, T, H, W, 3), dtype=np.float32)
    return {"imgs": imgs, "objs": objs, "triplets": triplets,
            "actions": actions, "boxes": boxes}


def make_ring(vocab, traffic, seed: int):
    """The traffic's `ring` distinct batches, from `seed`."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    return [make_batch(vocab, traffic, rng) for _ in range(traffic["ring"])]
