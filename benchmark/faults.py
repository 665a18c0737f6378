"""Faults planted in the program's timed path, to show that a broken path
comes out not correct (benchmark/tests, and `calibrate.py --faults` on the
card at a cell's own size).

Each fault takes the program's model and shadows one method of one of its
modules with a broken one (an instance attribute); `restore()` takes every
planted fault out again.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

_PLANTED: List[Tuple[object, str]] = []


def _plant(obj, name: str, fn) -> None:
    obj.__dict__[name] = fn
    _PLANTED.append((obj, name))


def restore() -> None:
    while _PLANTED:
        obj, name = _PLANTED.pop()
        obj.__dict__.pop(name, None)


def state_unchanged(model) -> None:
    """Each frame step hands back its input frames: the state never moves."""
    step = model.layout_to_video.frame_step
    fwd = step.forward

    def forward(prev, window, train=False):
        _, (img, flow, conf) = fwd(prev, window, train)
        return prev, (prev[..., -3:].float(), flow, conf)
    _plant(step, "forward", forward)


def half_batch(model) -> None:
    """Only the first half of the batch is computed; its outputs stand in
    for the second half (a cell of one clip has no such fault)."""
    fwd = model.forward

    def forward(imgs, objs, triplets, actions, boxes, **kw):
        h = imgs.shape[0] // 2
        out = fwd(imgs[:h], objs[:h], triplets[:h], actions[:h], boxes[:h],
                  **kw)
        return {k: (torch.cat([v, v]) if torch.is_tensor(v) else v)
                for k, v in out.items()}
    _plant(model, "forward", forward)


def _alter_second_frame(model, alter: Callable[[torch.Tensor], None]):
    """`alter` the first clip's second generated frame where the SPADE
    generator produces it, in every call; the frame loop feeds it on."""
    fwd_model = model.forward
    spade = model.layout_to_video.frame_step.netG
    fwd = spade.forward
    steps = [0]

    def forward_model(*a, **kw):
        steps[0] = 0
        return fwd_model(*a, **kw)

    def forward(x, train=False):
        y = fwd(x, train)
        steps[0] += 1
        if steps[0] == 2:
            y = y.clone()
            alter(y[0])
        return y
    _plant(model, "forward", forward_model)
    _plant(spade, "forward", forward)


def frame_altered(model) -> None:
    """An 8x8 patch of one generated frame is altered (+0.5)."""
    def alter(frame):
        frame[:8, :8] += 0.5
    _alter_second_frame(model, alter)


def frame_replaced(model) -> None:
    """One whole generated frame is altered (+0.5 on every pixel)."""
    def alter(frame):
        frame += 0.5
    _alter_second_frame(model, alter)


def box_altered(model) -> None:
    """One predicted box is moved where the rollout produces it."""
    step = model.acts_to_boxes.step
    fwd = step.forward

    def forward(*a):
        boxes, vecs = fwd(*a)
        boxes = boxes.clone()
        boxes[0, 0, 0] += 0.05
        return boxes, vecs
    _plant(step, "forward", forward)


ALL: Dict[str, Callable] = {f.__name__: f for f in (
    state_unchanged, half_batch, frame_altered, frame_replaced,
    box_altered)}

# The faults a comparison of whole clips is held to at a cell's own size:
# a frame (an answer) altered, not a patch of one. An 8x8 patch is 1/1024
# of a 256x256 frame and moves a clip by less than bf16 rounding does
# (PERF.md gives its readings); at the tests' 32x32 it is 1/16 and fails.
HELD = ("state_unchanged", "half_batch", "frame_replaced", "box_altered")


def applicable(batch: int, held_only: bool = False) -> List[str]:
    """The faults a cell of `batch` clips a call can have (of them, with
    `held_only`, those its comparison is held to)."""
    return [n for n in ALL if (n != "half_batch" or batch >= 2)
            and (n in HELD or not held_only)]
