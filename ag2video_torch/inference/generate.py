"""Generation (port of GenerationSession.generate,
ag2video_tpu/inference/generate.py:77-103).

`generate(model, batch)` runs the reference's test path,
`model(..., test_mode=True, use_gt=False)`: both layout rollouts from the
first frame's boxes, then autoregressive frame synthesis from the predicted
boxes. Loading orbax checkpoints is not ported yet; weights come from
`weights.from_flax` or the model's seeded init.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_DTYPES = {"imgs": torch.float32, "objs": torch.long, "boxes": torch.float32,
           "triplets": torch.long, "actions": torch.float32}


def make_inputs(cfg, vocab: Dict[str, Any], B: int, T: int,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Fixed-shape synthetic model inputs from a numpy seed (the recipe of
    the JAX package's `__graft_entry__._make_inputs`, as numpy arrays)."""
    rng = np.random.RandomState(seed)
    O, E, A = cfg.max_objects, cfg.max_triplets, cfg.max_actions
    num_attr = len(vocab["attributes"])
    H, W = cfg.image_size
    objs = rng.randint(1, 3, (B, O, num_attr))
    objs[:, -1] = 0
    triplets = np.stack(
        [rng.randint(0, O, (B, T, E)),
         rng.randint(0, len(vocab["pred_idx_to_name"]), (B, T, E)),
         rng.randint(0, O, (B, T, E))], -1)
    actions = np.concatenate(
        [rng.randint(0, O, (B, A, 1)),
         rng.randint(1, 3, (B, A, 1)),
         rng.randint(0, O, (B, A, 1)),
         rng.uniform(-0.5, 0.5, (B, A, 2)),
         rng.uniform(0, 1, (B, A, 2))], -1).astype(np.float32)
    boxes = rng.uniform(0.1, 0.5, (B, T, O, 4)).astype(np.float32)
    imgs = rng.randn(B, T, H, W, 3).astype(np.float32)
    return {"imgs": imgs, "objs": objs, "triplets": triplets,
            "actions": actions, "boxes": boxes}


def generate(model: torch.nn.Module, batch: Any,
             actions: Optional[np.ndarray] = None, layout_only: bool = False
             ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Generate videos -> (imgs_pred (B, T, H, W, 3) | None,
    boxes_pred (B, T, O, 4)), as tensors on the model's device.

    `batch` is a collate `Batch` or a mapping of its arrays. `actions`
    (A, 7) or (B, A, 7) overrides the batch's actions, padded or trimmed to
    the static action cap as the JAX session does. layout_only=True returns
    the box rollout only and skips pixel synthesis.
    """
    b: Mapping[str, Any] = batch.as_dict() if hasattr(batch, "as_dict") \
        else batch
    if actions is not None:
        a = np.asarray(actions, np.float32)
        if a.ndim == 2:
            a = np.broadcast_to(a[None], (np.shape(b["imgs"])[0],) + a.shape)
        cap = max(model.config.max_actions, np.shape(b["actions"])[1])
        pad_act = model.vocab["action_name_to_idx"]["__padding__"]
        padded = np.zeros((a.shape[0], cap, 7), np.float32)
        padded[:, :, 1] = pad_act
        padded[:, :min(a.shape[1], cap)] = a[:, :cap]
        b = dict(b, actions=padded)
    dev = next(model.parameters()).device
    t = {k: torch.as_tensor(b[k]).to(dev, _DTYPES[k]) for k in _DTYPES}
    model.eval()
    with torch.no_grad():
        out = model(t["imgs"], t["objs"], t["triplets"], t["actions"],
                    t["boxes"], test_mode=True, graph_only=layout_only)
    if layout_only:
        return None, out["boxes_pred"]
    return out["imgs_pred"], out["boxes_pred"]
