"""Layout -> video generator (port of ag2video_tpu/models/generator.py).

Ported path: the dense frontend (`factorized_frontend=False`) in
autoregressive mode (test-time generation). All B*T layouts are rasterized
by one `boxes_to_layout_batch` call (the CUDA kernel on the card); then, per
generated frame, the window of the last n_frames_G layouts and the previous
frame(s) feed the flow network, the previous frame is warped by the flow,
[layout window, warped frame] goes through `conv_dim_in` to semantic_nc
channels, and the SPADE generator's output is added onto the warped frame.
The JAX package's `nn.scan` over frames is a Python loop over one shared
`frame_step`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ag2video_torch.models.embeddings import AttributeEmbeddings
from ag2video_torch.models.flow import FlowsGenerator
from ag2video_torch.models.layers import leaky_relu_02
from ag2video_torch.models.normalization import NormConv
from ag2video_torch.models.spade import SPADEGenerator
from ag2video_torch.ops.rasterize import boxes_to_layout_batch
from ag2video_torch.ops.warp import resample

# Appearance-embedding width fed to the rasterizer (reference generator.py:16).
APPEARANCE_DIM = 384
# Photometric-confidence threshold (reference generator.py:77).
CONF_THRESHOLD = 0.02


def remove_dummy_objects_mask(objs: torch.Tensor) -> torch.Tensor:
    """(..., O, A) attribute ids -> (..., O) bool, True for real objects (the
    dummy __image__ object and padded slots both have first id 0)."""
    return objs[..., 0] != 0


class _FrameStep(nn.Module):
    """One generated frame, dense frontend:
    (prev frames (B, H, W, ncond*3), layout window (B, H, W, nF*Dseg)) ->
    (new prev frames, (frame, flow, conf))."""

    def __init__(self, seg_channels: int, semantic_nc: int, n_frames_G: int,
                 ngf: int, norm_G: str, norm_F: str,
                 num_upsampling_layers: str, aspect_ratio: float, nff: int,
                 n_blocks_F: int, n_downsample_F: int, flow_multiplier: float,
                 flow_deconv: bool, dtype: Optional[torch.dtype] = None):
        super().__init__()
        ncond = n_frames_G - 1
        self.n_frames_G = n_frames_G
        win = n_frames_G * seg_channels
        self.flows_network = FlowsGenerator(
            win + 3 * ncond, nff, n_blocks_F, n_downsample_F, norm_F,
            flow_multiplier, flow_deconv, dtype=dtype)
        self.conv_dim_in = NormConv(win + 3, semantic_nc, norm_F, 3,
                                    dtype=dtype)
        self.netG = SPADEGenerator(semantic_nc, ngf, norm_G,
                                   num_upsampling_layers, aspect_ratio, dtype)

    def forward(self, imgs_prev: torch.Tensor, seg_win: torch.Tensor):
        input_flow = torch.cat([seg_win, imgs_prev.to(seg_win.dtype)], dim=-1)
        _weight, flow = self.flows_network(input_flow)

        prev_last = imgs_prev[..., -3:].float()
        img_prev_warp = resample(prev_last, flow)
        err = ((prev_last - img_prev_warp) ** 2).sum(-1, keepdim=True)
        conf = (err < CONF_THRESHOLD).float()

        x = torch.cat([seg_win, img_prev_warp.to(seg_win.dtype)], dim=-1)
        x = leaky_relu_02(self.conv_dim_in(x))
        img_raw = self.netG(x).float() + img_prev_warp

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
        if factorized_frontend:
            raise NotImplementedError(
                "factorized_frontend=True is not ported yet: ROADMAP "
                "'Slices of the port' item 2 (the factorized frontend)")
        num_attr = len(vocab["attributes"])
        cards = {a: max(t.values()) + 1
                 for a, t in vocab["attributes"].items()}
        self.n_frames_G = n_frames_G
        # 'auto' (the CUDA kernel on the card) or 'plain' (the closed form,
        # set only to use it as the kernel's oracle); see ops/rasterize.py.
        self.rasterizer_backend = "auto"
        self.attribute_embedding = AttributeEmbeddings(
            cards, APPEARANCE_DIM // num_attr, dtype=dtype)
        seg_channels = (APPEARANCE_DIM // num_attr) * num_attr + gconv_dim
        self.frame_step = _FrameStep(
            seg_channels, semantic_nc, n_frames_G, ngf, norm_G, norm_F,
            num_upsampling_layers, aspect_ratio, nff, n_blocks_F,
            n_downsample_F, flow_multiplier, flow_deconv, dtype)

    def forward(self, imgs_gt: torch.Tensor, objs: torch.Tensor,
                obj_vecs: torch.Tensor, layout_boxes: torch.Tensor,
                teacher_forced: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """imgs_gt (B, T, H, W, 3), objs (B, O, A), obj_vecs (B, T, O, G),
        layout_boxes (B, T, O, 4) -> (imgs_pred (B, T, H, W, 3),
        flows (B, T, H, W, 2), confs (B, T, H, W, 1)), all fp32."""
        if teacher_forced:
            raise NotImplementedError(
                "teacher-forced generation is not ported yet: ROADMAP "
                "'Slices of the port' item 3 (the training slice)")
        B, T, H, W, _ = imgs_gt.shape
        ncond = self.n_frames_G - 1
        if T <= ncond:
            raise ValueError(f"need more than {ncond} frames, got T={T}")

        att = self.attribute_embedding(objs)  # (B, O, 384)
        att_t = att[:, None].expand(B, T, *att.shape[1:])
        vecs = torch.cat([att_t, obj_vecs.to(att.dtype)], dim=-1)
        obj_mask = remove_dummy_objects_mask(objs)
        mask_bt = obj_mask[:, None].expand(layout_boxes.shape[:-1])
        seg = boxes_to_layout_batch(vecs, layout_boxes, H, W, mask=mask_bt,
                                    backend=self.rasterizer_backend)

        # Autoregressive loop; the window ending at frame t + ncond is the
        # channel stack of seg[t .. t + ncond] (reference seg_t, :66).
        prev = torch.cat([imgs_gt[:, i] for i in range(ncond)], dim=-1)
        imgs, flows, confs = [], [], []
        for t in range(T - ncond):
            win = torch.cat([seg[:, t + i] for i in range(ncond + 1)], dim=-1)
            prev, (img, flow, conf) = self.frame_step(prev, win)
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
