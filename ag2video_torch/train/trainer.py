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

The training run (reference scripts/train.py:398-513; JAX trainer.py:304-637)
is `fit`: the loop over the loaders, the validation passes (`check_model`:
layout IoU; the Inception Score and the synthetic fidelity score of the
generated frames), checkpoints (`train/checkpoint.py`), the metrics stream
and step timing.

`Trainer(cfg, vocab)` runs on the CUDA card and raises without one;
`device="cpu"` runs on the CPU (the tests do). Not ported: two pieces of
TPU plumbing, the host-RSS watchdog (`rss_watchdog_gb`) and the
donation-miscompile warning (`donate_step`): both stay in the config and
are ignored.

Data parallel (`mesh=`, a `parallel.make_mesh` data axis; the JAX
Trainer's `mesh=`): every rank holds the whole state (`replicate` at init
and after a restore) and feeds its own slice of the global batch. Every
forward runs inside `parallel.data_scope`, so train-mode BatchNorms take
global-batch statistics; after each backward, one `allreduce_grads`
averages that network's gradients before the finiteness check and the
Adam, so the ranks take the same step. Every loss is averaged over the
ranks (`allreduce_mean`) before the NaN check and the metrics: the skip is
a global decision, as the JAX step's (one rank stepping while another
restores would part their weights for good), and the metrics are
global-batch means. `check_model` sums its statistics locally and reduces
them once after its loop (two ranks' val slices may differ by a batch), and
gathers the scorers' features in the split's order. Host-side writes
(checkpoints, run_args.json, videos, traces) are rank 0's; the metrics
writer is the caller's (the CLI gives rank 0 one).

Why not DistributedDataParallel: `frozen` toggles `requires_grad` on D
during the G step, which DDP does not allow once built; `graph_only`
forwards reach a subset of G's parameters; `NormState.restore` rewinds
buffers DDP would broadcast again. The JAX step reduces once per step
too, which one explicit all-reduce per network does.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from ag2video_torch.config import Config
# INCEPTION_WEIGHTS: where the val Inception Score's asset is read.
from ag2video_torch.eval.inception import DEFAULT_WEIGHTS as INCEPTION_WEIGHTS
from ag2video_torch.eval.inception import (InceptionScore,
                                           load_inception_params)
from ag2video_torch.losses.loss_model import (compute_discriminator_loss,
                                              compute_generator_loss,
                                              compute_graph_loss)
from ag2video_torch.ops.metrics import iou_stats
from ag2video_torch.parallel.mesh import (Mesh, allreduce_grads,
                                          allreduce_mean,
                                          allreduce_sum_array, data_scope,
                                          gather_in_split_order,
                                          process_index, replicate)
from ag2video_torch.train import checkpoint as ckpt_lib
from ag2video_torch.train.state import TrainState, create_train_state
from ag2video_torch.utils.profiling import span

log = logging.getLogger(__name__)

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


# The exit code (EX_TEMPFAIL, "restart me") of a run that stopped at its
# wall-clock deadline: a wrapper resumes it with --restore_checkpoint 1.
DEADLINE_RC = 75


class Trainer:
    def __init__(self, cfg: Config, vocab: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None,
                 mesh: Optional[Mesh] = None):
        """device: None means the CUDA card, which raises without one;
        "cpu" for the CPU. mesh: the data axis to train over (None: this
        process alone)."""
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA card is available; pass "
                               "device='cpu' to train on the CPU")
        self.cfg, self.vocab, self.device = cfg, vocab, device
        self.mesh = mesh
        self.state: Optional[TrainState] = None

    # ------------------------------------------------------------------
    def init(self, sample_batch: Any = None) -> TrainState:
        """Build the models and optimizers (seeded from cfg.seed; with a
        mesh, replicated from rank 0 and checked equal on every rank). The
        sample batch, when given, is checked against the config's frame
        size."""
        if sample_batch is not None:
            H, W = self._batch(sample_batch)["imgs"].shape[2:4]
            if (H, W) != tuple(self.cfg.image_size):
                raise ValueError(f"batch frames {(H, W)} vs config "
                                 f"image_size {self.cfg.image_size}")
        self.state = create_train_state(self.cfg, self.vocab, self.device)
        self._replicate()
        return self.state

    def _replicate(self) -> None:
        """Rank 0's models and optimizer states on every rank (no mesh:
        nothing)."""
        if self.mesh is None:
            return
        st = self.state
        for obj in (st.model, st.disc, st.vgg, st.opt_graph, st.opt_gen,
                    st.opt_d):
            if obj is not None:
                replicate(obj, self.mesh)

    def _reduce_grads(self, module: nn.Module) -> None:
        """Average `module`'s gradients over the mesh (no mesh: nothing)."""
        if self.mesh is not None:
            allreduce_grads(module.parameters(), self.mesh)

    def _global(self, losses: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The losses, detached, averaged over the mesh."""
        if self.mesh is None:
            return {k: v.detach() for k, v in losses.items()}
        return dict(zip(losses, allreduce_mean(list(losses.values()),
                                               self.mesh)))

    @property
    def skipped_nan(self) -> int:
        return self.state.skipped_nan

    def _batch(self, batch: Any, skip_imgs: bool = False
               ) -> Dict[str, torch.Tensor]:
        b: Mapping[str, Any] = batch.as_dict() if hasattr(batch, "as_dict") \
            else batch
        out = {}
        with span("ag2v.train.upload"):
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
        gradients (averaged over the mesh) in the model's `.grad` ->
        (local losses, model outputs)."""
        st, cfg = self.state, self.cfg
        for p in st.model.parameters():
            p.grad = None
        with frozen(st.disc), data_scope(self.mesh):
            out = st.model(b["imgs"], b["objs"], b["triplets"],
                           b["actions"], b["boxes"], test_mode=False,
                           use_gt=True, train=True)

            def d_apply(img, objs, boxes, actions_data, img2=None):
                return st.disc(img, objs, boxes, actions_data, train=False,
                               img2=img2)

            losses = compute_generator_loss(cfg, b, out, d_apply, st.vgg)
            losses["total_loss"].backward()
        self._reduce_grads(st.model)
        return losses, out

    def discriminator_backward(self, b: Dict[str, torch.Tensor],
                               model_out: Dict[str, Any]):
        """One D step's forward and backward, no update: D in train mode on
        the detached generated frames -> local losses; gradients (averaged
        over the mesh) in D's `.grad`."""
        st = self.state
        for p in st.disc.parameters():
            p.grad = None

        def d_apply(img, objs, boxes, actions_data, img2=None):
            return st.disc(img, objs, boxes, actions_data, train=True,
                           img2=img2)

        with data_scope(self.mesh):
            losses = compute_discriminator_loss(self.cfg, b, model_out,
                                                d_apply)
        losses["total_img_loss"].backward()
        self._reduce_grads(st.disc)
        return losses

    def train_step(self, batch: Any) -> Dict[str, torch.Tensor]:
        """G step + D step on one batch -> metrics (0-dim tensors)."""
        st = self.state
        b = self._batch(batch)

        with span("ag2v.train.g"):
            g_norms = NormState(st.model)
            g_losses, model_out = self.generator_backward(b)
            g_losses = self._global(g_losses)
            g_ok = _finite(g_losses["total_loss"])
            if g_ok:
                st.opt_gen.step()
            else:
                g_norms.restore()
        metrics = {f"G/{k}": v for k, v in g_losses.items()}

        d_ok = True
        for _ in range(max(self.cfg.D_steps_per_G, 1)):
            with span("ag2v.train.d"):
                d_norms = NormState(st.disc)
                d_losses = self._global(
                    self.discriminator_backward(b, model_out))
                d_ok = d_ok and _finite(d_losses["total_img_loss"])
                if d_ok:
                    st.opt_d.step()
                else:
                    d_norms.restore()
        metrics.update({f"D/{k}": v for k, v in d_losses.items()})

        st.skipped_nan += int(not (g_ok and d_ok))
        st.step += 1
        return metrics

    def graph_loss(self, b: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        with data_scope(self.mesh):
            out = self.state.model(b["imgs"], b["objs"], b["triplets"],
                                   b["actions"], b["boxes"], test_mode=False,
                                   graph_only=True, train=True)
        return compute_graph_loss(self.cfg, b, out["boxes_pred"])

    def graph_step(self, batch: Any) -> Dict[str, torch.Tensor]:
        """The graph-only loss on long clips and the graph Adam (reference
        train.py:470-493) -> metrics."""
        st = self.state
        b = self._batch(batch, skip_imgs=True)
        with span("ag2v.train.graph"):
            if self.cfg.freeze_graph:
                # --freeze_graph: the loss is reported, nothing is updated
                # (reference freeze_weights, train.py:60-64, 386-387).
                with torch.no_grad():
                    losses = self._global(self.graph_loss(b))
                return {f"Graph/{k}": v for k, v in losses.items()}
            for p in st.model.parameters():
                p.grad = None
            losses = self.graph_loss(b)
            losses["total_loss"].backward()
            self._reduce_grads(st.model)
            losses = self._global(losses)
            if _finite(losses["total_loss"]):
                st.opt_graph.step()
            else:
                st.skipped_nan += 1
        return {f"Graph/{k}": v for k, v in losses.items()}

    # ------------------------------------------------------------------
    def _eval_forward(self, b: Dict[str, torch.Tensor], use_gt: bool):
        """The val forward (reference check_model, train.py:136-252):
        test_mode=True; with use_gt=False only the first frame's boxes seed
        the rollout. -> (imgs_pred, boxes_pred clipped to [0, 1], the IoU
        sums of frames 1.. over the real objects)."""
        boxes = b["boxes"]
        boxes_in = boxes if use_gt else torch.cat(
            [boxes[:, :1], torch.zeros_like(boxes[:, 1:])], 1)
        with torch.no_grad(), data_scope(self.mesh):
            out = self.state.model(b["imgs"], b["objs"], b["triplets"],
                                   b["actions"], boxes_in, test_mode=True,
                                   use_gt=use_gt, train=False)
        boxes_pred = out["boxes_pred"].clamp(0.0, 1.0)
        # Mask: strip frame 0, the dummy and the padding (train.py:180-197).
        real = b["objs"][..., 0] != 0
        mask = torch.broadcast_to(real[:, None, :], boxes[:, 1:].shape[:-1])
        stats = iou_stats(boxes_pred[:, 1:], boxes[:, 1:], mask)
        return out["imgs_pred"], boxes_pred, stats

    def eval_batch(self, batch: Any, use_gt: bool):
        """The val forward on one batch -> (imgs_pred, boxes_pred,
        (sum_iou, count@0.5, count@0.3, n_valid)), tensors on the device."""
        return self._eval_forward(self._batch(batch), use_gt)

    def spectral_stats(self) -> Dict[str, float]:
        """Spectral-norm telemetry: min/mean/max of every stored power-
        iteration sigma in G and D (the JAX package's `sigma` leaves; the
        factorized frontend's own spectral norm stores none)."""
        out: Dict[str, float] = {}
        for tag, module in (("G", self.state.model), ("D", self.state.disc)):
            sigmas = [b.reshape(-1) for n, b in module.named_buffers()
                      if n.endswith("spectral.sigma")]
            if not sigmas:
                continue
            s = torch.cat(sigmas).cpu().numpy()
            out[f"sigma/{tag}_min"] = float(s.min())
            out[f"sigma/{tag}_mean"] = float(s.mean())
            out[f"sigma/{tag}_max"] = float(s.max())
        return out

    def check_model(self, loader, use_gt: bool,
                    max_samples: Optional[int] = None, inception_score=None,
                    fidelity_score=None):
        """Validation pass (reference check_model, train.py:136-252) ->
        (mean metrics, samples dict for the video artifacts). The IoU
        triple is reported by the use_gt=False pass only;
        `inception_score` (eval.inception.InceptionScore) scores every
        frame of the pass (reference train.py:175, 247) under the tag
        `inception`, or `inception_randomnet` on random weights;
        `fidelity_score` (eval.backbone.FidelityScore) scores the generated
        frames, the ground-truth seed frames dropped, against the same
        clips' real frames.

        With a mesh, each rank reads its own slice of the split and stops
        after ceil(max_samples / world) samples; the IoU sums and the
        presence counts are reduced once after the loop (the slices may
        differ by a batch, so no collective runs per batch), and the
        scorers' features are gathered in the split's order. An unshuffled
        split that runs out before max_samples thus scores as one process
        scores it; a longer one does not in general, since each rank stops
        at a whole batch, and the clips scored differ from one process's.
        The samples are the rank's own."""
        from ag2video_torch.eval.backbone import presence_labels

        max_samples = max_samples or self.cfg.num_val_samples
        if self.mesh is not None:
            max_samples = -(-max_samples // self.mesh.world)
        tot = np.zeros(4)
        samples = {}
        n_seen = 0
        if inception_score is not None:
            inception_score.clean()
        if fidelity_score is not None:
            fidelity_score.clean()
        ncond = self.cfg.n_frames_G - 1  # conditioning frames pass through
        frames = self.cfg.frames_per_action  # per clip
        for batch in loader.epoch(0):
            b = self._batch(batch)
            imgs_pred, boxes_pred, stats = self._eval_forward(b, use_gt)
            frames = imgs_pred.shape[1]
            tot += np.array([float(s) for s in stats])
            if inception_score is not None:
                inception_score(imgs_pred.reshape(-1, *imgs_pred.shape[2:]))
            if fidelity_score is not None:
                fake = imgs_pred[:, ncond:]
                T = fake.shape[1]
                objs = np.asarray(batch.objs)  # (B, O, [shape, color, size])
                pres = presence_labels(
                    {"shape": objs[..., 0], "color": objs[..., 1]})
                fidelity_score.add_fake(fake.reshape(-1, *fake.shape[2:]),
                                        presence=np.repeat(pres, T, axis=0))
                real = b["imgs"][:, ncond:]
                fidelity_score.add_real(real.reshape(-1, *real.shape[2:]))
            if not samples:
                samples = {
                    "video_id": batch.video_ids,
                    "vids": np.asarray(batch.imgs),
                    "gt_boxes": np.asarray(batch.boxes),
                    "pred_boxes": boxes_pred.float().cpu().numpy(),
                    "pred_vids": imgs_pred.float().cpu().numpy(),
                }
            n_seen += batch.imgs.shape[0]
            if n_seen >= max_samples:
                break
        if self.mesh is not None:
            tot = allreduce_sum_array(tot, self.mesh, self.device)
            self._gather_scores(inception_score, fidelity_score, frames,
                                ncond)
        denom = max(tot[3], 1.0)
        # The layout rollout ignores boxes_in past the seed frame, so the
        # IoU triple is the same in both modes: only use_gt=False reports
        # it (use_gt=True scores generated frames).
        mean_losses = {} if use_gt else {
            "avg_iou": tot[0] / denom,
            "total_iou_05": tot[1] / denom,
            "total_iou_03": tot[2] / denom,
        }
        if inception_score is not None:
            m, s = inception_score.compute_score(splits=5)
            tag = "inception" if not inception_score.random_init \
                else "inception_randomnet"
            mean_losses[f"{tag}_mean"] = m
            mean_losses[f"{tag}_std"] = s
        if fidelity_score is not None:
            mean_losses.update(fidelity_score.compute())
        return mean_losses, samples

    def _gather_scores(self, inception_score, fidelity_score, T: int,
                       ncond: int) -> None:
        """Every rank's scorer state on every rank, in the split's order:
        the Inception Score's T frames per clip, the fidelity score's T -
        ncond generated and real frames per clip and its presence
        counts."""
        def gather(parts, rows):
            x = np.concatenate(parts) if parts else np.zeros((0, 0),
                                                             np.float32)
            x = gather_in_split_order(x, rows, self.mesh, self.device)
            return [x] if len(x) else []

        if inception_score is not None:
            inception_score._probs = gather(inception_score._probs, T)
        if fidelity_score is not None:
            fs = fidelity_score
            fs._fake_feats = gather(fs._fake_feats, T - ncond)
            fs._real_feats = gather(fs._real_feats, T - ncond)
            fs._n_ok, fs._n_tot = (int(v) for v in allreduce_sum_array(
                np.array([fs._n_ok, fs._n_tot], np.int64), self.mesh,
                self.device))

    # ------------------------------------------------------------------
    def save_checkpoint(self, output_dir: str, t: int, epoch: int,
                        block: bool = True, light: bool = False) -> str:
        return ckpt_lib.save_checkpoint(output_dir, t, epoch, self.state,
                                        self.cfg, self.vocab, block=block,
                                        light=light)

    def restore_checkpoint(self, path: str, for_inference: bool = False):
        """Every rank reads the checkpoint; with a mesh, rank 0's state is
        then replicated."""
        state = ckpt_lib.restore_checkpoint(path, self.state, self.cfg,
                                            for_inference=for_inference)
        self._replicate()
        return state

    # ------------------------------------------------------------------
    def _scorers(self, val_loader, inception_score=None):
        """The val pass's scorers -> (inception_score, fidelity_score), each
        None when off. An injected `inception_score` is kept; otherwise,
        with `val_inception`, one is built from the InceptionV3 asset, and
        with no asset the Inception Score is skipped with a warning, as the
        JAX trainer skips it."""
        cfg = self.cfg
        if val_loader is None or cfg.graph_only:
            return inception_score, None
        if inception_score is None and cfg.val_inception:
            params = load_inception_params(INCEPTION_WEIGHTS)
            if params is not None:
                inception_score = InceptionScore(params, device=self.device)
            else:
                log.warning(
                    "no pretrained InceptionV3 asset: SKIPPING the val "
                    "Inception Score — a random-init backbone scores a "
                    "constant ~1.0 (zero signal) and costs an inception "
                    "forward per val frame; port weights via "
                    "scripts/port_torch_weights.py to enable it")
        if not (cfg.val_fidelity and cfg.dataset == "synthetic"):
            return inception_score, None
        from ag2video_torch.eval.backbone import (DEFAULT_WEIGHTS,
                                                  FidelityScore,
                                                  load_backbone)
        path = cfg.fidelity_backbone or DEFAULT_WEIGHTS
        loaded = load_backbone(path)
        if loaded is None:
            log.warning(
                "no synthetic fidelity backbone asset (%s): the use_gt "
                "val pass reports no pixel-quality metric — train one "
                "with `python -m scripts.train_backbone`", path)
            return inception_score, None
        return inception_score, FidelityScore(loaded[0], device=self.device)

    def _validate(self, val_loader, t: int, scorers, metrics_writer):
        """Both validation passes at step t, their metrics and videos; the
        use_gt pass takes the `scorers` of `_scorers`."""
        from ag2video_torch.utils.vis import save_images

        inception_score, fidelity_score = scorers
        for use_gt in (True, False):
            m, samples = self.check_model(
                val_loader, use_gt,
                inception_score=inception_score if use_gt else None,
                fidelity_score=fidelity_score if use_gt else None)
            tag = "use_gt" if use_gt else "no_use_gt"
            log.info("val[%s] @%d: %s", tag, t, m or "(artifacts only)")
            if metrics_writer and m:
                metrics_writer.write(t, {f"{tag}/{k}": v
                                         for k, v in m.items()})
            # Per-checkpoint videos (reference save_images, train.py:415,
            # 422): rank 0's; vis is best-effort.
            if process_index() != 0:
                continue
            try:
                save_images(self.cfg.output_dir, t, samples,
                            dir_name="gt_val" if use_gt else "val")
            except Exception as e:
                log.warning("save_images failed: %s", e)

    def _past(self, deadline: float) -> bool:
        """Whether the clock is past `deadline` here, or with a mesh on any
        of its ranks."""
        late = np.array([time.time() >= deadline], np.int64)
        if self.mesh is not None:
            late = allreduce_sum_array(late, self.mesh, self.device)
        return bool(late[0])

    def fit(self, train_loader, graph_loader, val_loader=None,
            num_iterations: Optional[int] = None,
            log_every: Optional[int] = None,
            checkpoint_every: Optional[int] = None,
            metrics_writer=None, timing: bool = False,
            inception_score=None):
        """The reference main loop (train.py:398-513), host side; returns the
        last iteration's metrics. The use_gt validation pass scores the
        generated frames with `inception_score` when given (tests inject
        one), else with one built from the InceptionV3 asset when
        cfg.val_inception is set (`_scorers`).

        Saves at t % checkpoint_every == 0 (async; every
        full_checkpoint_every_n-th one full, the rest light), except at the
        step it resumed from, each followed by both validation passes; logs
        every log_every steps; saves a full checkpoint at the end if an
        iteration ran. `profile_steps` traces steps [start+2, start+2+N)
        into <output_dir>/profile (rank 0's). Past `wall_deadline` it saves
        a full checkpoint (when there is an output_dir) and exits with
        DEADLINE_RC; with a mesh, every rank stops at the first logged step
        at which any rank is past it. `rss_watchdog_gb` and `donate_step`
        (TPU plumbing) are ignored.
        """
        from ag2video_torch.utils.profiling import (StepTimer, start_trace,
                                                    stop_trace)

        cfg = self.cfg
        scorers = self._scorers(val_loader, inception_score)
        num_iterations = num_iterations or cfg.num_iterations
        log_every = log_every or cfg.print_every
        checkpoint_every = checkpoint_every or cfg.checkpoint_every
        timer = StepTimer() if timing else None
        profile_dir = os.path.join(cfg.output_dir or ".", "profile")

        train_iter = train_loader.forever() if not cfg.graph_only else None
        graph_iter = graph_loader.forever()
        t0 = time.time()
        last: Dict[str, Any] = {}
        t = start_t = int(self.state.step)
        profile_at = (start_t + 2) if cfg.profile_steps \
            and process_index() == 0 else None
        prof = None
        while t < num_iterations:
            if profile_at is not None and prof is None and t >= profile_at:
                prof = start_trace()
            elif prof is not None and t >= profile_at + cfg.profile_steps:
                log.info("wrote trace %s", stop_trace(prof, profile_dir))
                prof, profile_at = None, None
            # Save and validate on the cadence, but not at the resume point
            # (t == start_t > 0): that checkpoint was just read.
            if (checkpoint_every and t % checkpoint_every == 0
                    and cfg.output_dir and (t == 0 or t > start_t)):
                n_full = max(cfg.full_checkpoint_every_n, 1)
                light = (t // checkpoint_every) % n_full != 0
                with span("ag2v.fit.save"):
                    self.save_checkpoint(cfg.output_dir, t, 0, block=False,
                                         light=light)
                if val_loader is not None:
                    with span("ag2v.fit.validate"):
                        self._validate(val_loader, t, scorers,
                                       metrics_writer)
            if not cfg.graph_only:
                with span("ag2v.fit.wait"):
                    batch = next(train_iter)
                last.update(self.train_step(batch))
            with span("ag2v.fit.wait"):
                batch = next(graph_iter)
            last.update(self.graph_step(batch))
            if cfg.graph_only:
                t += 1
                self.state.step = t
            else:
                t = int(self.state.step)
            if timer is not None:
                timer.tick()

            if t % log_every == 0:
                vals = {k: float(v) for k, v in last.items()}
                if not cfg.graph_only:
                    vals.update(self.spectral_stats())
                    vals["skipped_nan"] = float(self.state.skipped_nan)
                if timer is not None:
                    vals.update(timer.stats())
                rate = t / max(time.time() - t0, 1e-9)
                log.info("t=%d/%d (%.2f it/s) %s", t, num_iterations, rate,
                         {k: round(v, 4) for k, v in vals.items()})
                if metrics_writer:
                    metrics_writer.write(t, vals)
                if cfg.wall_deadline and self._past(cfg.wall_deadline):
                    log.error("wall deadline %.0f reached — %s, exiting "
                              "rc=%d for auto-resume", cfg.wall_deadline,
                              f"saving a FULL checkpoint at t={t}"
                              if cfg.output_dir else "no output_dir to "
                              "save into", DEADLINE_RC)
                    if prof is not None:
                        stop_trace(prof, profile_dir)
                    if cfg.output_dir:
                        self.save_checkpoint(cfg.output_dir, t, 0)
                    ckpt_lib.wait_for_saves()
                    raise SystemExit(DEADLINE_RC)
        # The in-loop cadence saves at an iteration's start, so the state
        # after the last iterations is saved here (the reference saves on
        # exit, train.py:525-528), unless no iteration ran.
        if prof is not None:
            log.info("wrote trace %s", stop_trace(prof, profile_dir))
        if cfg.output_dir and checkpoint_every and t > start_t:
            self.save_checkpoint(cfg.output_dir, t, 0)
        ckpt_lib.wait_for_saves()  # commit any in-flight async save
        return last
