"""Layout -> video generator (port of ag2video_tpu/models/generator.py).

Per generated frame, the window of the last n_frames_G layouts and the
previous frame(s) feed the flow network, the previous frame is warped by the
flow, the layout window and the warped frame go through `conv_dim_in` to
semantic_nc channels, and the SPADE generator's output is added onto the
warped frame. Two modes share one `frame_step`:

* teacher-forced (training; the previous frames come from the ground
  truth): every frame is conditionally independent, so (B, T - ncond) is
  folded into the batch and `frame_step` runs once, as the JAX package
  does (generator.py:268-280);
* autoregressive (test-time generation, and training with `bp_prev`): the
  JAX package's `nn.scan` over frames is a Python loop over `frame_step`,
  each frame fed the frames generated before it. In train mode the JAX
  scan carries `batch_stats` and `spectral` from frame to frame, which is
  torch's per-forward semantics: every frame's forward updates the BN
  running statistics and the spectral `u` / sigma in turn, and the
  gradient flows back through the earlier generated frames. No norm
  writes a buffer that a frame's graph saved for backward: the BNs
  normalise by the batch statistics in train mode, and the spectral norms
  save the new `u` they computed, not the buffer they copy it into. (The
  JAX frame step is rematerialized; the port's is not.)

* Factorized frontend (`factorized_frontend=True`, the default config): the
  per-object box coverage maps are computed once (`box_coverage`, cast to
  the vecs' dtype) and the two frontend convs, `flow_down_0` (in front of a
  `FlowsGenerator(skip_first=True)`) and `conv_dim_in`, consume each
  frame's (coverage, vecs) window in the object basis (models/factorized.py),
  each with its leaky ReLU (one launch of csrc/objconv.cu for the pair on
  the card in eval mode). Nothing is rasterized.
* Dense frontend (`factorized_frontend=False`): all B*T layouts are
  rasterized by one `boxes_to_layout_batch` call (the CUDA kernel on the
  card) and each frame's window is their channel stack.

`train=True` runs the norms in train mode (batch statistics, spectral
updates), once per forward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ag2video_torch.models.embeddings import AttributeEmbeddings
from ag2video_torch.models.factorized import FactorizedNormConv
from ag2video_torch.models.flow import FlowsGenerator
from ag2video_torch.models.layers import leaky_relu_02
from ag2video_torch.models.normalization import NormConv
from ag2video_torch.models.spade import SPADEGenerator
from ag2video_torch.ops.rasterize import box_coverage, boxes_to_layout_batch
from ag2video_torch.ops.warp import resample
from ag2video_torch.utils.profiling import span

# Appearance-embedding width fed to the rasterizer (reference generator.py:16).
APPEARANCE_DIM = 384
# Photometric-confidence threshold (reference generator.py:77).
CONF_THRESHOLD = 0.02


def remove_dummy_objects_mask(objs: torch.Tensor) -> torch.Tensor:
    """(..., O, A) attribute ids -> (..., O) bool, True for real objects (the
    dummy __image__ object and padded slots both have first id 0)."""
    return objs[..., 0] != 0


class _FrameStep(nn.Module):
    """One generated frame: (prev frames (B, H, W, ncond*3), window) ->
    (new prev frames, (frame, flow, conf)). The window is the layout stack
    (B, H, W, nF*Dseg) on the dense frontend and (coverage (B, nF, O, H, W),
    vecs (B, nF, O, Dseg)) on the factorized one."""

    def __init__(self, seg_channels: int, semantic_nc: int, n_frames_G: int,
                 ngf: int, norm_G: str, norm_F: str,
                 num_upsampling_layers: str, aspect_ratio: float, nff: int,
                 n_blocks_F: int, n_downsample_F: int, flow_multiplier: float,
                 flow_deconv: bool, factorized: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ncond = n_frames_G - 1
        self.n_frames_G = n_frames_G
        self.factorized = factorized
        win = n_frames_G * seg_channels
        if factorized:
            self.flow_down_0 = FactorizedNormConv(
                nff, norm_F, seg_channels, n_frames_G, 3 * ncond, dtype=dtype)
        self.flows_network = FlowsGenerator(
            win + 3 * ncond, nff, n_blocks_F, n_downsample_F, norm_F,
            flow_multiplier, flow_deconv, skip_first=factorized, dtype=dtype)
        if factorized:
            self.conv_dim_in = FactorizedNormConv(
                semantic_nc, norm_F, seg_channels, n_frames_G, 3, dtype=dtype)
        else:
            self.conv_dim_in = NormConv(win + 3, semantic_nc, norm_F, 3,
                                        dtype=dtype)
        self.netG = SPADEGenerator(semantic_nc, ngf, norm_G,
                                   num_upsampling_layers, aspect_ratio, dtype)

    def forward(self, imgs_prev: torch.Tensor, window, train: bool = False):
        with span("ag2v.frame"):
            with span("ag2v.frame.flow"):
                if self.factorized:
                    cov_win, vecs_win = window
                    feat = self.flow_down_0(cov_win, vecs_win, imgs_prev,
                                            train)
                    _weight, flow = self.flows_network(feat, train)
                else:
                    input_flow = torch.cat(
                        [window, imgs_prev.to(window.dtype)], dim=-1)
                    _weight, flow = self.flows_network(input_flow, train)

            with span("ag2v.frame.warp"):
                prev_last = imgs_prev[..., -3:].float()
                img_prev_warp = resample(prev_last, flow)
                err = ((prev_last - img_prev_warp) ** 2).sum(-1, keepdim=True)
                conf = (err < CONF_THRESHOLD).float()

            with span("ag2v.frame.conv_in"):
                if self.factorized:
                    x = self.conv_dim_in(cov_win, vecs_win,
                                         img_prev_warp.to(cov_win.dtype),
                                         train)
                else:
                    x = leaky_relu_02(self.conv_dim_in(
                        torch.cat([window, img_prev_warp.to(window.dtype)],
                                  dim=-1), train))

            with span("ag2v.frame.spade"):
                img_raw = self.netG(x, train).float() + img_prev_warp
                if self.n_frames_G - 1 > 1:
                    new_prev = torch.cat([imgs_prev[..., 3:], img_raw], dim=-1)
                else:
                    new_prev = img_raw
        return new_prev, (img_raw, flow, conf)


class Layout2VidGenerator(nn.Module):
    """Reference Layout2VidGenerator (generator.py:11-93)."""

    def __init__(self, vocab: Dict[str, Any], gconv_dim: int = 128,
                 n_frames_G: int = 2, semantic_nc: int = 512, ngf: int = 64,
                 norm_G: str = "spectralspadesyncbatch3x3",
                 norm_F: str = "spectralsyncbatch",
                 num_upsampling_layers: str = "normal",
                 aspect_ratio: float = 1.0, nff: int = 32,
                 n_blocks_F: int = 6, n_downsample_F: int = 3,
                 flow_multiplier: float = 20.0, flow_deconv: bool = False,
                 factorized_frontend: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        num_attr = len(vocab["attributes"])
        cards = {a: max(t.values()) + 1
                 for a, t in vocab["attributes"].items()}
        self.n_frames_G = n_frames_G
        self.factorized_frontend = factorized_frontend
        self.attribute_embedding = AttributeEmbeddings(
            cards, APPEARANCE_DIM // num_attr, dtype=dtype)
        seg_channels = (APPEARANCE_DIM // num_attr) * num_attr + gconv_dim
        self.frame_step = _FrameStep(
            seg_channels, semantic_nc, n_frames_G, ngf, norm_G, norm_F,
            num_upsampling_layers, aspect_ratio, nff, n_blocks_F,
            n_downsample_F, flow_multiplier, flow_deconv,
            factorized_frontend, dtype)

    def forward(self, imgs_gt: torch.Tensor, objs: torch.Tensor,
                obj_vecs: torch.Tensor, layout_boxes: torch.Tensor,
                teacher_forced: bool = False, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """imgs_gt (B, T, H, W, 3), objs (B, O, A), obj_vecs (B, T, O, G),
        layout_boxes (B, T, O, 4) -> (imgs_pred (B, T, H, W, 3),
        flows (B, T, H, W, 2), confs (B, T, H, W, 1)), all fp32.

        T is the layouts'. The autoregressive path reads only the first
        ncond = n_frames_G - 1 frames of imgs_gt, so it may hold just those;
        the teacher-forced path needs all T."""
        B, T = layout_boxes.shape[:2]
        H, W = imgs_gt.shape[2:4]
        ncond = self.n_frames_G - 1
        if T <= ncond:
            raise ValueError(f"need more than {ncond} frames, got T={T}")
        if teacher_forced and imgs_gt.shape[1] != T:
            raise ValueError(f"teacher forcing needs all {T} frames, got "
                             f"{imgs_gt.shape[1]}")
        if imgs_gt.shape[1] < ncond:
            raise ValueError(f"need the {ncond} conditioning frames, got "
                             f"{imgs_gt.shape[1]}")

        att = self.attribute_embedding(objs)  # (B, O, 384)
        att_t = att[:, None].expand(B, T, *att.shape[1:])
        vecs = torch.cat([att_t, obj_vecs.to(att.dtype)], dim=-1)
        obj_mask = remove_dummy_objects_mask(objs)
        mask_bt = obj_mask[:, None].expand(layout_boxes.shape[:-1])
        if self.factorized_frontend:
            # Coverage in the vecs' dtype before the contraction, as the
            # JAX package casts it (bf16 in the bf16 config).
            cov = box_coverage(layout_boxes, H, W, mask_bt).to(vecs.dtype)
        else:
            seg = boxes_to_layout_batch(vecs, layout_boxes, H, W,
                                        mask=mask_bt)

        n_gen = T - ncond
        if teacher_forced:
            # Every frame at once: the previous frames come from the ground
            # truth, so (B, n_gen) folds into the batch. Windows of frames
            # t .. t + ncond: the channel stack of those layouts, or their
            # (coverage, vecs) on the factorized frontend.
            fold = lambda a: a.reshape(B * n_gen, *a.shape[2:])
            if self.factorized_frontend:
                win = tuple(fold(torch.stack(
                    [a[:, i:i + n_gen] for i in range(ncond + 1)], dim=2))
                    for a in (cov, vecs))
            else:
                win = fold(torch.cat(
                    [seg[:, i:i + n_gen] for i in range(ncond + 1)], dim=-1))
            prev = fold(torch.cat(
                [imgs_gt[:, i:i + n_gen] for i in range(ncond)], dim=-1))
            _, (img, flow, conf) = self.frame_step(prev, win, train)
            imgs, flows, confs = (
                list(a.reshape(B, n_gen, *a.shape[1:]).unbind(1))
                for a in (img, flow, conf))
        else:
            # Autoregressive loop over the same windows (reference seg_t,
            # :66), each frame fed the frames generated before it.
            prev = torch.cat([imgs_gt[:, i] for i in range(ncond)], dim=-1)
            imgs, flows, confs = [], [], []
            for t in range(n_gen):
                if self.factorized_frontend:
                    win = (cov[:, t:t + ncond + 1], vecs[:, t:t + ncond + 1])
                else:
                    win = torch.cat([seg[:, t + i] for i in range(ncond + 1)],
                                    dim=-1)
                prev, (img, flow, conf) = self.frame_step(prev, win, train)
                imgs.append(img)
                flows.append(flow)
                confs.append(conf)

        # Conditioning frames, then generated frames; flow/conf aligned at
        # index t-1 (reference generator.py:78-79).
        imgs_pred = torch.stack(
            [imgs_gt[:, i].float() for i in range(ncond)] + imgs, dim=1)
        z2 = imgs_gt.new_zeros((B, H, W, 2), dtype=torch.float32)
        z1 = imgs_gt.new_zeros((B, H, W, 1), dtype=torch.float32)
        flows_full = torch.stack([z2] * (ncond - 1) + flows + [z2], dim=1)
        confs_full = torch.stack([z1] * (ncond - 1) + confs + [z1], dim=1)
        return imgs_pred, flows_full, confs_full
