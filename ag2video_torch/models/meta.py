"""The composed model (port of ag2video_tpu/models/meta.py).

AG2VideoModel = two Acts2LayoutModel rollouts, `acts_to_boxes` for motion and
`acts_to_objs` for appearance, feeding Layout2VidGenerator. Predicted boxes
are detached before generation (reference meta_models.py:53).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ag2video_torch.config import Config
from ag2video_torch.models.generator import Layout2VidGenerator
from ag2video_torch.models.layout_model import Acts2LayoutModel
from ag2video_torch.weights import init_params


class AG2VideoModel(nn.Module):
    """forward(imgs, objs, triplets, actions, boxes_gt, ...) ->
    dict(imgs_pred, boxes_pred, flows_pred, conf_pred, actions_data)."""

    def __init__(self, config: Config, vocab: Dict[str, Any]):
        super().__init__()
        cfg = config
        self.config = cfg
        self.vocab = vocab
        dtype = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype \
            else None
        kw = dict(vocab=vocab, embedding_dim=cfg.embedding_dim,
                  gconv_dim=cfg.gconv_dim,
                  gconv_hidden_dim=cfg.gconv_hidden_dim,
                  gconv_num_layers=cfg.gconv_num_layers,
                  gconv_pooling=cfg.gconv_pooling,
                  mlp_normalization=cfg.mlp_normalization,
                  only_temporal=cfg.only_temporal, dtype=dtype)
        self.acts_to_boxes = Acts2LayoutModel(**kw)
        if not cfg.coupled_motion_apperance:
            self.acts_to_objs = Acts2LayoutModel(**kw)
        self.layout_to_video = Layout2VidGenerator(
            vocab=vocab, gconv_dim=cfg.gconv_dim, n_frames_G=cfg.n_frames_G,
            semantic_nc=cfg.generator_cond_nc or cfg.semantic_nc,
            ngf=cfg.ngf, norm_G=cfg.norm_G, norm_F=cfg.norm_F,
            num_upsampling_layers=cfg.num_upsampling_layers,
            aspect_ratio=cfg.aspect_ratio, nff=cfg.nff,
            n_blocks_F=cfg.n_blocks_F, n_downsample_F=cfg.n_downsample_F,
            flow_multiplier=cfg.flow_multiplier, flow_deconv=cfg.flow_deconv,
            factorized_frontend=cfg.factorized_frontend, dtype=dtype)
        # Seeded random weights until a checkpoint or weights.from_flax
        # replaces them.
        init_params(self, cfg.seed)
        # Only inference is ported: the norms read running statistics.
        self.eval()

    def forward(self, imgs: torch.Tensor, objs: torch.Tensor,
                triplets: torch.Tensor, actions: torch.Tensor,
                boxes_gt: torch.Tensor, test_mode: bool = True,
                use_gt: bool = False,
                graph_only: bool = False) -> Dict[str, Any]:
        obj_vecs, boxes_pred, actions_data = self.acts_to_boxes(
            objs, triplets, actions, boxes_gt)
        if graph_only:
            return {"boxes_pred": boxes_pred, "actions_data": actions_data}
        if not self.config.coupled_motion_apperance:
            obj_vecs, _, actions_data = self.acts_to_objs(
                objs, triplets, actions, boxes_gt)

        gen_boxes = boxes_gt if use_gt else boxes_pred.detach()
        teacher_forced = (not test_mode) and (not self.config.bp_prev)
        imgs_pred, flows_pred, conf_pred = self.layout_to_video(
            imgs, objs, obj_vecs, gen_boxes, teacher_forced=teacher_forced)
        return {
            "imgs_pred": imgs_pred,
            "boxes_pred": boxes_pred,
            "flows_pred": flows_pred,
            "conf_pred": conf_pred,
            "actions_data": actions_data,
        }
