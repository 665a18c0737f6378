"""Faults planted in the program's training step, to show that a broken
step comes out not correct (benchmark/tests, and `calibrate_train.py
--faults` on the card at a cell's own size).

Each fault takes the program's `Trainer` and shadows one of its methods,
or one of its models' or optimizers' (an instance attribute), or replaces
one field of its state; `restore()` takes every planted fault out again.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

_PLANTED: List[Tuple[object, str, object]] = []
_ABSENT = object()


def _plant(obj, name: str, value) -> None:
    _PLANTED.append((obj, name, obj.__dict__.get(name, _ABSENT)))
    obj.__dict__[name] = value


def restore() -> None:
    while _PLANTED:
        obj, name, old = _PLANTED.pop()
        if old is _ABSENT:
            obj.__dict__.pop(name, None)
        else:
            obj.__dict__[name] = old


def _zeros(trainer, names):
    z = torch.zeros((), device=trainer.device)
    return {k: z for k in names}


def state_unchanged(trainer) -> None:
    """No Adam updates anything: the weights stay as they were."""
    st = trainer.state
    for opt in (st.opt_graph, st.opt_gen, st.opt_d):
        _plant(opt, "step", lambda *a, **k: None)


def half_batch(trainer) -> None:
    """Every step sees the first half of its batch; the losses are the
    means over that half."""
    upload = trainer._batch

    def _batch(batch, skip_imgs=False):
        b = upload(batch, skip_imgs)
        return {k: v[:max(v.shape[0] // 2, 1)] for k, v in b.items()}
    _plant(trainer, "_batch", _batch)


def vgg_dropped(trainer) -> None:
    """The generator's loss leaves out the VGG perceptual term."""
    _plant(trainer.state, "vgg", None)


def d_step_skipped(trainer) -> None:
    """The D step does nothing: no discriminator loss, no update."""
    _plant(trainer, "discriminator_backward", lambda b, out: _zeros(
        trainer, ("D_img_fake", "D_img_real", "total_img_loss")))
    _plant(trainer.state.opt_d, "step", lambda *a, **k: None)


def g_norms_eval(trainer) -> None:
    """The generator's norms run in eval mode in its training forwards:
    the running statistics in place of the batch's, no spectral update."""
    model = trainer.state.model
    forward = model.forward

    def eval_forward(*a, **kw):
        return forward(*a, **dict(kw, train=False))
    _plant(model, "forward", eval_forward)


def graph_step_skipped(trainer) -> None:
    """The graph step does nothing: no rollout loss, no update."""
    _plant(trainer, "graph_step", lambda batch: {
        f"Graph/{k}": v for k, v in _zeros(
            trainer, ("bbox_pred", "total_loss")).items()})


ALL: Dict[str, Callable] = {f.__name__: f for f in (
    state_unchanged, half_batch, vgg_dropped, d_step_skipped, g_norms_eval,
    graph_step_skipped)}
