"""The training step (port of ag2video_tpu/train/trainer.py:138-283).

One iteration is a `train_step` on short clips (the G step, then the D
step) and a `graph_step` on 4x longer clips, the reference's dual-loader
scheme (scripts/train.py:425-493). In the JAX order:

* G step: the model forward in train mode (batch statistics; BN running
  averages and spectral state written once), the generator losses against
  a frozen discriminator (`train=False`: no spectral update, no gradient
  into D), backward, the generator Adam.
* D step: the discriminator losses on the *same* forward's detached
  frames, D in train mode (one power iteration per batched real+fake
  call), backward, the D Adam; `D_steps_per_G` times.
* graph step: the layout rollout only (`graph_only`), the graph loss, the
  graph Adam (or nothing with `freeze_graph`).

NaN guard (reference train.py:450-453; JAX `_tree_select`): a non-finite
loss takes no optimizer step and restores the norm state the forward
wrote, so params, optimizer state and norm state stay as they were; the
`skipped_nan` counter goes up once per step that skipped anything.

`Trainer(cfg, vocab)` runs on the CUDA card and raises without one;
`device="cpu"` runs on the CPU (the tests do). Not ported yet: checkpoints,
`fit`, the validation pass (ROADMAP).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ag2video_torch.config import Config
from ag2video_torch.losses.loss_model import (compute_discriminator_loss,
                                              compute_generator_loss,
                                              compute_graph_loss)
from ag2video_torch.train.state import TrainState, create_train_state

BATCH_KEYS = ("imgs", "objs", "triplets", "actions", "boxes")


@contextlib.contextmanager
def frozen(module: nn.Module):
    """No gradient into `module`'s parameters inside the block."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class NormState:
    """A copy of a module's buffers (BN running statistics, spectral `u` and
    sigma), to put back when a step is skipped."""

    def __init__(self, module: nn.Module):
        self.buffers = list(module.buffers())
        self.saved = [b.clone() for b in self.buffers]

    def restore(self) -> None:
        with torch.no_grad():
            for b, s in zip(self.buffers, self.saved):
                b.copy_(s)


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x))


class Trainer:
    def __init__(self, cfg: Config, vocab: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None):
        """device: None means the CUDA card, which raises without one;
        "cpu" for the CPU."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA card is available; pass "
                               "device='cpu' to train on the CPU")
        self.cfg, self.vocab, self.device = cfg, vocab, device
        self.state: Optional[TrainState] = None

    # ------------------------------------------------------------------
    def init(self, sample_batch: Any = None) -> TrainState:
        """Build the models and optimizers (seeded from cfg.seed). The
        sample batch, when given, is checked against the config's frame
        size."""
        if sample_batch is not None:
            H, W = self._batch(sample_batch)["imgs"].shape[2:4]
            if (H, W) != tuple(self.cfg.image_size):
                raise ValueError(f"batch frames {(H, W)} vs config "
                                 f"image_size {self.cfg.image_size}")
        self.state = create_train_state(self.cfg, self.vocab, self.device)
        return self.state

    @property
    def skipped_nan(self) -> int:
        return self.state.skipped_nan

    def set_rasterizer_backend(self, backend: str) -> None:
        """'auto' (the CUDA kernel on the card) or 'plain' (its closed form,
        the kernel's oracle) for every rasterizer call of G and D."""
        self.state.model.layout_to_video.rasterizer_backend = backend
        self.state.disc.rasterizer_backend = backend

    def _batch(self, batch: Any, skip_imgs: bool = False
               ) -> Dict[str, torch.Tensor]:
        b: Mapping[str, Any] = batch.as_dict() if hasattr(batch, "as_dict") \
            else batch
        out = {}
        for k in BATCH_KEYS:
            v = b[k]
            if k == "imgs" and skip_imgs:
                # The graph loss never reads pixels: a rank-preserving
                # stub instead of the frames, as the JAX trainer sends.
                v = np.zeros(tuple(v.shape[:2]) + (1, 1, 3), np.float32)
            out[k] = torch.as_tensor(v).to(self.device)
        return out

    # ------------------------------------------------------------------
    def generator_backward(self, b: Dict[str, torch.Tensor]):
        """The G step's forward and backward, no update: the model in train
        mode, the generator losses against the frozen D. Leaves the
        gradients in the model's `.grad` -> (losses, model outputs)."""
        st, cfg = self.state, self.cfg
        for p in st.model.parameters():
            p.grad = None
        with frozen(st.disc):
            out = st.model(b["imgs"], b["objs"], b["triplets"],
                           b["actions"], b["boxes"], test_mode=False,
                           use_gt=True, train=True)

            def d_apply(img, objs, boxes, actions_data, img2=None):
                return st.disc(img, objs, boxes, actions_data, train=False,
                               img2=img2)

            losses = compute_generator_loss(cfg, b, out, d_apply, st.vgg)
            losses["total_loss"].backward()
        return losses, out

    def discriminator_backward(self, b: Dict[str, torch.Tensor],
                               model_out: Dict[str, Any]):
        """One D step's forward and backward, no update: D in train mode on
        the detached generated frames -> losses; gradients in D's `.grad`."""
        st = self.state
        for p in st.disc.parameters():
            p.grad = None

        def d_apply(img, objs, boxes, actions_data, img2=None):
            return st.disc(img, objs, boxes, actions_data, train=True,
                           img2=img2)

        losses = compute_discriminator_loss(self.cfg, b, model_out, d_apply)
        losses["total_img_loss"].backward()
        return losses

    def train_step(self, batch: Any) -> Dict[str, torch.Tensor]:
        """G step + D step on one batch -> metrics (0-dim tensors)."""
        st = self.state
        b = self._batch(batch)

        g_norms = NormState(st.model)
        g_losses, model_out = self.generator_backward(b)
        g_ok = _finite(g_losses["total_loss"])
        if g_ok:
            st.opt_gen.step()
        else:
            g_norms.restore()
        metrics = {f"G/{k}": v.detach() for k, v in g_losses.items()}

        d_ok = True
        for _ in range(max(self.cfg.D_steps_per_G, 1)):
            d_norms = NormState(st.disc)
            d_losses = self.discriminator_backward(b, model_out)
            d_ok = d_ok and _finite(d_losses["total_img_loss"])
            if d_ok:
                st.opt_d.step()
            else:
                d_norms.restore()
        metrics.update({f"D/{k}": v.detach() for k, v in d_losses.items()})

        st.skipped_nan += int(not (g_ok and d_ok))
        st.step += 1
        return metrics

    def graph_loss(self, b: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        out = self.state.model(b["imgs"], b["objs"], b["triplets"],
                               b["actions"], b["boxes"], test_mode=False,
                               graph_only=True, train=True)
        return compute_graph_loss(self.cfg, b, out["boxes_pred"])

    def graph_step(self, batch: Any) -> Dict[str, torch.Tensor]:
        """The graph-only loss on long clips and the graph Adam (reference
        train.py:470-493) -> metrics."""
        st = self.state
        b = self._batch(batch, skip_imgs=True)
        if self.cfg.freeze_graph:
            # --freeze_graph: the loss is reported, nothing is updated
            # (reference freeze_weights, train.py:60-64, 386-387).
            with torch.no_grad():
                losses = self.graph_loss(b)
            return {f"Graph/{k}": v for k, v in losses.items()}
        for p in st.model.parameters():
            p.grad = None
        losses = self.graph_loss(b)
        losses["total_loss"].backward()
        if _finite(losses["total_loss"]):
            st.opt_graph.step()
        else:
            st.skipped_nan += 1
        return {f"Graph/{k}": v.detach() for k, v in losses.items()}
