"""Graph -> layout model (port of ag2video_tpu/models/layout_model.py).

Per timestep t = 1..F-1: concat [attribute embedding, previous boxes] ->
obj_vecs_net, `gconv_num_layers` GraphTripleConv layers over spatial-relation
edges and time-gated action edges, and a box *delta* added to the previous
box. All time-dependent inputs are built for every t up front; the JAX
package's `nn.scan` becomes a Python loop over one shared `step` module.

`MaskNet` and `create_mask_vecs` are the latent per-object mask head.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ag2video_torch.models.embeddings import AttributeEmbeddings
from ag2video_torch.models.gcn import GraphTripleConv
from ag2video_torch.models.layers import (MLP, Conv, Dense, Embed,
                                          upsample_nearest)
from ag2video_torch.models.normalization import BatchNorm


def action_clock(actions: torch.Tensor, timesteps: int,
                 pad_action_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """actions (B, A, 7) rows [s, a, o, f1, f2, x_end, y_end] ->
    (relative_timesteps (B, F, A) fp32, gated action ids (B, F, A) int32).
    Reference model.py:109-122."""
    a_id = actions[..., 1]
    f1 = actions[..., 3].float()
    f2 = actions[..., 4].float()
    t = torch.arange(timesteps, dtype=torch.float32,
                     device=actions.device)[None, :, None]
    rel = (t / timesteps) * (f2 - f1 + 1e-6)[:, None, :] + f1[:, None, :]
    included = (rel >= 0) & (rel <= 1)
    gated = torch.where(included, a_id[:, None, :].to(rel.dtype),
                        torch.full_like(rel, float(pad_action_idx)))
    return rel, gated.to(torch.int32)


class _LayoutStep(nn.Module):
    """One rollout step (shared weights across t)."""

    def __init__(self, embedding_dim: int, gconv_dim: int,
                 gconv_hidden_dim: int, gconv_num_layers: int,
                 gconv_pooling: str, obj_input_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.obj_vecs_net_0 = Dense(obj_input_dim + 4, obj_input_dim,
                                    use_bias=False, dtype=dtype)
        self.obj_vecs_net_1 = Dense(obj_input_dim, obj_input_dim,
                                    use_bias=False, dtype=dtype)
        self.n_layers = gconv_num_layers
        obj_in = obj_input_dim
        for i in range(gconv_num_layers):
            setattr(self, f"gconv_{i}", GraphTripleConv(
                obj_in, embedding_dim if i == 0 else gconv_dim, gconv_dim,
                gconv_dim, gconv_hidden_dim, gconv_pooling, dtype))
            obj_in = gconv_dim
        self.box_net = MLP(gconv_dim, [gconv_hidden_dim, 4],
                           final_relu=False, dtype=dtype)

    def forward(self, boxes_prev, obj_embed, pred_vecs, edges, ind):
        x = torch.cat([obj_embed, boxes_prev.to(obj_embed.dtype)], dim=-1)
        x = torch.relu(self.obj_vecs_net_0(x))
        obj_vecs = torch.relu(self.obj_vecs_net_1(x))
        for i in range(self.n_layers):
            obj_vecs, pred_vecs = getattr(self, f"gconv_{i}")(
                obj_vecs, pred_vecs, edges, ind)
        delta = self.box_net(obj_vecs)
        return boxes_prev + delta.float(), obj_vecs


class Acts2LayoutModel(nn.Module):
    """Reference Acts2LayoutModel (model.py:23-174)."""

    def __init__(self, vocab: Dict[str, Any], embedding_dim: int = 128,
                 gconv_dim: int = 128, gconv_hidden_dim: int = 512,
                 gconv_num_layers: int = 3, gconv_pooling: str = "avg",
                 mlp_normalization: str = "none", only_temporal: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        # mlp_normalization: read and never used, as in the JAX package.
        self.vocab = vocab
        self.gconv_dim = gconv_dim
        self.only_temporal = only_temporal
        num_attr = len(vocab["attributes"])
        cards = {a: max(t.values()) + 1
                 for a, t in vocab["attributes"].items()}
        self.attribute_embedding = AttributeEmbeddings(
            cards, embedding_dim, dtype=dtype)
        self.acts_embeddings = Embed(len(vocab["action_idx_to_name"]),
                                     embedding_dim, dtype)
        if not only_temporal:
            self.pred_embeddings = Embed(len(vocab["pred_idx_to_name"]),
                                         embedding_dim, dtype)
        self.step = _LayoutStep(embedding_dim, gconv_dim, gconv_hidden_dim,
                                gconv_num_layers, gconv_pooling,
                                num_attr * embedding_dim, dtype)

    def forward(self, objs: torch.Tensor, triplets: torch.Tensor,
                actions: torch.Tensor, boxes_gt: torch.Tensor):
        """objs (B, O, A) int, triplets (B, F, E, 3) int, actions
        (B, A_act, 7), boxes_gt (B, >=1, O, 4) -> (temporal_obj_vecs
        (B, F, O, gconv_dim), boxes_pred (B, F, O, 4) fp32, actions_data)."""
        vocab = self.vocab
        B, F = triplets.shape[0], triplets.shape[1]
        O = objs.shape[1]
        pad_pred = vocab["pred_name_to_idx"]["__padding__"]
        pad_act = vocab["action_name_to_idx"]["__padding__"]

        obj_embed = self.attribute_embedding(objs)  # (B, O, num_attr * D)
        rel_t, gated = action_clock(actions, F, pad_act)  # (B, F, A)
        s_a = actions[:, None, :, 0].expand(gated.shape)
        o_a = actions[:, None, :, 2].expand(gated.shape)
        x_end = actions[:, None, :, 5].expand(gated.shape)
        y_end = actions[:, None, :, 6].expand(gated.shape)

        acts_vecs = self.acts_embeddings(gated)  # (B, F, A, D)
        tail = torch.stack([x_end, y_end, rel_t], dim=-1).to(acts_vecs.dtype)
        acts_vecs = torch.cat([acts_vecs[..., :-3], tail], dim=-1)
        action_edges = torch.stack([s_a, o_a], dim=-1).to(torch.int32)
        action_ind = gated != pad_act

        if not self.only_temporal:
            p_p = triplets[..., 1]
            spatial_vecs = self.pred_embeddings(p_p)  # (B, F, E, D)
            spatial_edges = torch.stack([triplets[..., 0], triplets[..., 2]],
                                        dim=-1).to(torch.int32)
            edges = torch.cat([spatial_edges, action_edges], dim=2)
            pred_vecs = torch.cat([spatial_vecs, acts_vecs], dim=2)
            indicators = torch.cat([p_p != pad_pred, action_ind], dim=2)
        else:
            edges, pred_vecs, indicators = action_edges, acts_vecs, action_ind

        # The rollout (reference model.py:126-169).
        boxes = boxes_gt[:, 0].float()  # (B, O, 4)
        boxes_seq, vecs_seq = [boxes], []
        for t in range(1, F):
            boxes, obj_vecs = self.step(boxes, obj_embed, pred_vecs[:, t],
                                        edges[:, t], indicators[:, t])
            boxes_seq.append(boxes)
            vecs_seq.append(obj_vecs)
        boxes_pred = torch.stack(boxes_seq, dim=1)
        zeros0 = obj_embed.new_zeros((B, 1, O, self.gconv_dim))
        if vecs_seq:
            zeros0 = zeros0.to(vecs_seq[0].dtype)
        temporal_obj_vecs = torch.cat(
            [zeros0] + [v[:, None] for v in vecs_seq], dim=1)

        temporal_triplets = torch.stack(
            [s_a.to(torch.int32), gated, o_a.to(torch.int32)], dim=-1)
        actions_data = {
            "triplets": triplets,
            "temporal_triplets": temporal_triplets,
            "relative_timesteps": rel_t,
            "locs": torch.stack([x_end, y_end], dim=-1),
        }
        return temporal_obj_vecs, boxes_pred, actions_data


class MaskNet(nn.Module):
    """Per-object soft-mask head (reference _build_mask_net, model.py:76-97):
    from 1x1, stages of nearest x2 upsample, 3x3 conv, BatchNorm and relu up
    to mask_size, then a 1x1 conv to one channel and a sigmoid. Off by
    default (Config.mask_size = 0) and not wired into the layout model, as
    upstream; it feeds `ops.rasterize.masks_to_layout`."""

    def __init__(self, features: int, mask_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if mask_size & (mask_size - 1):
            raise ValueError("Mask size must be a power of 2")
        self.n_stages = 0
        while (1 << self.n_stages) < mask_size:
            i = self.n_stages
            setattr(self, f"conv_{i}", Conv(features, features, 3,
                                            dtype=dtype))
            setattr(self, f"bn_{i}", BatchNorm(features))
            self.n_stages += 1
        self.conv_out = Conv(features, 1, 1, dtype=dtype)

    def forward(self, mask_vecs: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        """mask_vecs (..., D) -> (..., mask_size, mask_size) masks, each
        value in (0, 1)."""
        lead = mask_vecs.shape[:-1]
        x = mask_vecs.reshape(-1, 1, 1, mask_vecs.shape[-1])
        for i in range(self.n_stages):
            x = upsample_nearest(x, 2)
            x = getattr(self, f"conv_{i}")(x)
            x = torch.relu(getattr(self, f"bn_{i}")(x, train))
        x = self.conv_out(x)
        size = 1 << self.n_stages
        return torch.sigmoid(x[..., 0]).reshape(*lead, size, size)


def create_mask_vecs(obj_vecs: torch.Tensor, generator: torch.Generator,
                     mask_noise_dim: int) -> torch.Tensor:
    """Object vectors (B, O, D) with one N(0, 1) noise vector, drawn from
    `generator` (on its device), appended to every (batch, object) slot
    (reference create_mask_vecs, model.py:90-97)."""
    noise = torch.randn((1, 1, mask_noise_dim), generator=generator,
                        device=generator.device)
    noise = noise.to(obj_vecs.device, obj_vecs.dtype).expand(
        *obj_vecs.shape[:-1], mask_noise_dim)
    return torch.cat([obj_vecs, noise], dim=-1)
