"""Rule-based layout baseline (port of ag2video_tpu/models/rule_baseline.py).

The reference's `scripts/test_iou.py:4` imports a `RuleBasedModel` that does
not exist anywhere in its repo. This is the obvious baseline the graph
model must beat: boxes follow the action semantics literally — `_slide` /
`_pick_place` subjects move linearly from their seed position to
(x_end, y_end) with the action clock's progress (layout_model.action_clock);
everything else stays put. No learned parameters.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ag2video_torch.models.layout_model import action_clock


def rule_based_boxes(
    objs: torch.Tensor,       # (B, O, A) — unused, kept for API parity
    triplets: torch.Tensor,   # (B, F, T, 3) — frames count source
    actions: torch.Tensor,    # (B, A_act, 7)
    boxes_gt: torch.Tensor,   # (B, F, O, 4); [:, 0] seeds
    vocab: Dict[str, Any],
) -> torch.Tensor:
    """Returns (B, F, O, 4) fp32 rule-rollout boxes, on `actions`' device."""
    B, F = triplets.shape[0], triplets.shape[1]
    O = boxes_gt.shape[2]
    names = vocab["action_name_to_idx"]
    pad_act = names["__padding__"]
    move_ids = [names.get("_slide", -1), names.get("_pick_place", -1)]

    rel, gated = action_clock(actions, F, pad_act)   # (B, F, A)
    rel = rel.clamp(0.0, 1.0)
    # Subject ids index the objects; an id past the end takes the last
    # object, as the JAX package's gather clamps it.
    subj = actions[..., 0].long().clamp(0, O - 1)    # (B, A)
    x_end = actions[..., 5].float()
    y_end = actions[..., 6].float()
    seed = boxes_gt[:, 0].float()                    # (B, O, 4)

    # For each (frame, action): weight = progress if the action moves its
    # subject, else 0. Objects claimed by several actions mix their targets
    # by progress.
    is_move = torch.zeros_like(gated, dtype=torch.bool)
    for mid in move_ids:
        is_move |= gated == mid
    w = torch.where(is_move, rel, torch.zeros_like(rel))

    onehot = torch.eye(O, device=actions.device)[subj]      # (B, A, O)
    prog = torch.einsum("bfa,bao->bfo", w, onehot).clamp(0.0, 1.0)
    tx = torch.einsum("bfa,bao->bfo", w * x_end[:, None, :], onehot)
    ty = torch.einsum("bfa,bao->bfo", w * y_end[:, None, :], onehot)
    moving = prog > 0
    safe = torch.where(moving, prog, torch.ones_like(prog))
    tx = torch.where(moving, tx / safe, torch.zeros_like(tx))
    ty = torch.where(moving, ty / safe, torch.zeros_like(ty))

    x = seed[:, None, :, 0] * (1 - prog) + tx * prog
    y = seed[:, None, :, 1] * (1 - prog) + ty * prog
    wh = seed[:, None, :, 2:].expand(B, F, O, 2)
    return torch.cat([x[..., None], y[..., None], wh], dim=-1)
