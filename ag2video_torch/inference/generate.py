"""Generation (port of ag2video_tpu/inference/generate.py).

`generate(model, batch)` runs the reference's test path,
`model(..., test_mode=True, use_gt=False)`: both layout rollouts from the
first frame's boxes, then autoregressive frame synthesis from the predicted
boxes (or from the ground-truth boxes with use_gt=True).

`GenerationSession(run_dir)` renders a trained run: it reads the run's
`run_args.json`, builds the model on the card (or on `device`), and `load()`
reads the run's newest weights: a checkpoint of the port's own training
run (an `itr_<t>/` directory, train/checkpoint.py), or an `itr_<t>.npz` of
flax variables exported from a JAX run's orbax checkpoint
(torch_tools/export_run_weights.py). Its `generate` returns numpy arrays as the JAX session's does;
`run_action_sweep` and `save_test_outputs` write the same file tree as the
JAX session's methods (`save_test_outputs` writes each `.pkl` before its
GIF). The GIFs are the port's own (utils/gif.py), so no imageio is needed.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ag2video_torch.config import Config
from ag2video_torch.inference import actions as action_lib
from ag2video_torch.models.meta import AG2VideoModel
from ag2video_torch.train import checkpoint as ckpt_lib
from ag2video_torch.utils.profiling import span
from ag2video_torch.utils.vis import plot_vid, save_gif, save_video_pickle
from ag2video_torch.weights import from_flax, load_flax_npz

log = logging.getLogger(__name__)

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


def _upload(a: Any, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """An input array on `dev` in `dtype`, cast on the host by numpy (every
    cast is exact: int -> int64, fp32 -> fp32). For the card the block is
    pinned (the caching host allocator's, which keeps it until its copy has
    run) and copied without blocking, so the host does not wait for the
    card; numpy fills it in ~3/4 of the host time of torch's `copy_` (H100
    host, one thread)."""
    a = np.asarray(a)
    staged = torch.empty(a.shape, dtype=dtype, pin_memory=dev.type == "cuda")
    np.copyto(staged.numpy(), a, casting="unsafe")
    return staged.to(dev, non_blocking=True)


def generate(model: torch.nn.Module, batch: Any,
             actions: Optional[np.ndarray] = None, use_gt: bool = False,
             layout_only: bool = False
             ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Generate videos -> (imgs_pred (B, T, H, W, 3) | None,
    boxes_pred (B, T, O, 4)), as tensors on the model's device.

    `batch` is a collate `Batch` or a mapping of its arrays. `actions`
    (A, 7) or (B, A, 7) overrides the batch's actions, padded or trimmed to
    the static action cap as the JAX session does. use_gt=True renders from
    the ground-truth boxes (the reference's --use_test mode);
    layout_only=True returns the box rollout only and skips pixel synthesis.

    Only the conditioning frames of `imgs` (the first n_frames_G - 1) reach
    the device: the test path reads no other. On the card the call never
    waits for it; the outputs are ready once the stream has run.
    """
    with span("ag2v.generate"):
        b: Mapping[str, Any] = batch.as_dict() \
            if hasattr(batch, "as_dict") else batch
        if actions is not None:
            a = np.asarray(actions, np.float32)
            if a.ndim == 2:
                a = np.broadcast_to(a[None],
                                    (np.shape(b["imgs"])[0],) + a.shape)
            cap = max(model.config.max_actions, np.shape(b["actions"])[1])
            pad_act = model.vocab["action_name_to_idx"]["__padding__"]
            padded = np.zeros((a.shape[0], cap, 7), np.float32)
            padded[:, :, 1] = pad_act
            padded[:, :min(a.shape[1], cap)] = a[:, :cap]
            b = dict(b, actions=padded)
        dev = next(model.parameters()).device
        with span("ag2v.upload"):
            # The test path reads only the conditioning frames.
            ncond = model.config.n_frames_G - 1
            t = {k: _upload(np.asarray(b[k])[:, :ncond] if k == "imgs"
                            else b[k], _DTYPES[k], dev) for k in _DTYPES}
        model.eval()
        with torch.no_grad():
            out = model(t["imgs"], t["objs"], t["triplets"], t["actions"],
                        t["boxes"], test_mode=True, use_gt=use_gt,
                        graph_only=layout_only)
        if layout_only:
            return None, out["boxes_pred"]
        return out["imgs_pred"], out["boxes_pred"]


def latest_weights(run_dir: str) -> str:
    """The newest weights in `run_dir`: an `itr_<t>/` checkpoint of the
    port's (train/checkpoint.py) or an exported `itr_<t>.npz`; at the same
    t the port's checkpoint wins."""
    found = {}
    for p in glob.glob(os.path.join(os.path.abspath(run_dir), "itr_*.npz")):
        m = re.match(r"itr_(\d+)\.npz$", os.path.basename(p))
        if m:
            found[(int(m.group(1)), 0)] = p
    ckpt = ckpt_lib.latest_checkpoint(run_dir)
    if ckpt is not None:
        found[(int(os.path.basename(ckpt)[len("itr_"):]), 1)] = ckpt
    if not found:
        raise FileNotFoundError(
            f"no itr_<t>/ checkpoint or itr_*.npz weights under {run_dir}: "
            f"export a JAX run's checkpoint with "
            f"torch_tools/export_run_weights.py")
    return found[max(found)]


class GenerationSession:
    """A trained run, rendered by the port (see the module docstring)."""

    def __init__(self, run_dir: str, checkpoint: Optional[str] = None,
                 overrides: Optional[Dict[str, Any]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """checkpoint: an `itr_<t>/` checkpoint of the port, an
        `itr_<t>.npz`, or a directory whose newest weights are taken
        (default: `run_dir`). device: as AG2VideoModel's, the CUDA card when
        None."""
        cfg, vocab = Config.load_run_args(run_dir)
        if overrides:
            cfg = cfg.replace(**overrides)
        if vocab is None:
            raise ValueError(f"{run_dir}/run_args.json must embed the vocab")
        self.cfg = cfg
        self.vocab = vocab
        self.model = AG2VideoModel(cfg, vocab, device=device)
        self._checkpoint = checkpoint or run_dir
        self._loaded = False

    def load(self) -> "GenerationSession":
        """Read the weights strictly (every saved tensor used, every port
        tensor filled, like the reference's load_state_dict(strict=True))."""
        path = self._checkpoint
        if os.path.isdir(path) and not ckpt_lib.is_port_checkpoint(path):
            path = latest_weights(path)
        if ckpt_lib.is_port_checkpoint(path):
            state = ckpt_lib.load_state_file(path)["model"]
            self.model.load_state_dict(state, strict=True)
        else:
            load_flax_npz(path, self.model)
        self._loaded = True
        log.info("loaded %s", path)
        return self

    def load_variables(self, variables: Mapping[str, Any]
                       ) -> "GenerationSession":
        """Load flax-layout variables ({'params', 'batch_stats',
        'spectral'}), as the JAX session's `load_variables` takes them."""
        from_flax(variables, self.model)
        self._loaded = True
        return self

    def generate(self, batch: Any, actions: Optional[np.ndarray] = None,
                 use_gt: bool = False, layout_only: bool = False
                 ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """`generate` above, returning numpy arrays: (imgs_pred | None,
        boxes_pred)."""
        if not self._loaded:
            raise RuntimeError("call load() or load_variables() first")
        imgs, boxes = generate(self.model, batch, actions=actions,
                               use_gt=use_gt, layout_only=layout_only)
        return (None if imgs is None else imgs.cpu().numpy(),
                boxes.cpu().numpy())

    def run_action_sweep(self, batch: Any, out_dir: str,
                         dataset: Optional[str] = None) -> None:
        """The reference's --save_actions sweep (test.py:205-279): for each
        builder, generate the action, a 'before' timing variant, an 'after'
        timing variant, and save the GT clip."""
        dataset = dataset or self.cfg.dataset
        if dataset == "cater":
            builders = action_lib.cater_execute_set(self.vocab)
        else:
            slide = self.vocab["action_name_to_idx"].get("_slide", 1)
            builders = [{
                "action_name": "slide",
                "action_func": lambda objs, vids, boxes:
                    action_lib.single(0, slide, x_end=0.1, y_end=0.1),
            }]
        vid_id = batch.video_ids[0]
        for spec in builders:
            name = spec["action_name"]
            acts = spec["action_func"](batch.objs, batch.imgs, batch.boxes)
            if name == "converge":
                n_real = action_lib.real_object_count(batch.objs)
                before = action_lib.converge_before(n_real, int(acts[0, 1]))
                after = action_lib.converge_after(n_real, int(acts[0, 1]))
            else:
                before = action_lib.shift_before(acts)
                after = action_lib.shift_after(acts)
            variants = {
                os.path.join("action_accuracy", name): acts,
                os.path.join("action_timing", name, "before"): before,
                os.path.join("action_timing", name, "after"): after,
            }
            for rel, a in variants.items():
                imgs_pred, boxes_pred = self.generate(batch, actions=a)
                fn = os.path.join(out_dir, rel, f"{vid_id}.gif")
                save_gif(plot_vid(imgs_pred[0], boxes_pred[0]), fn)
                log.info("wrote %s", fn)
            gt_fn = os.path.join(out_dir, "gt_action", name, f"{vid_id}.gif")
            save_gif(plot_vid(np.asarray(batch.imgs)[0]), gt_fn)

    def save_test_outputs(self, batch: Any, out_dir: str,
                          use_gt: bool = True) -> None:
        """The reference's --save_test path (test.py:281-299): an
        {'image','box'} pkl and a gif per video, the pkl first; use_gt
        follows --use_test (default 1 upstream: generate from GT boxes)."""
        imgs_pred, boxes_pred = self.generate(batch, use_gt=use_gt)
        save_p = os.path.join(out_dir, "test")
        objs = np.asarray(batch.objs)
        for i, vid_id in enumerate(batch.video_ids):
            # Real objects occupy 0..n_real-1, the dummy sits at n_real and
            # padding after: keep the real ones (at least one row).
            n_real = int((objs[i, :, 0] != 0).sum())
            save_video_pickle(os.path.join(save_p, f"{vid_id}.pkl"),
                              imgs_pred[i], boxes_pred[i][:, :max(n_real, 1)])
            save_gif(plot_vid(imgs_pred[i]),
                     os.path.join(save_p, f"{vid_id}.gif"))
