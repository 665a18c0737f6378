"""Action-conditioned multiscale PatchGAN discriminators (port of
ag2video_tpu/models/discriminator.py).

A 2-layer GCN over the action edges runs recurrently over time, carrying the
object features (the JAX package's `nn.scan` is a Python loop over one
shared `gcn_step`); the object features, fused with the attribute
embeddings by `fc_objs_vecs`, are rasterized into a (B, T, H, W,
2*gconv_dim) conditioning map by `ops.rasterize.boxes_to_layout_batch` (the
CUDA kernel on the card, the plain version on the CPU), concatenated with
the frames channel-wise, and num_D PatchGANs run on successively pooled
scales. It returns a list (over scales) of lists of per-layer features, the
patch logits (fp32) last.

With `img2` (the batched real+fake pass) the conditioning is computed once
and the PatchGANs run on the stacked 2*B*T batch: one forward, so one
power iteration of each spectral norm. `train=True` stores the spectral
norms' new state; the instance norms have none.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ag2video_torch.models.embeddings import AttributeEmbeddings
from ag2video_torch.models.gcn import GraphTripleConv
from ag2video_torch.models.generator import remove_dummy_objects_mask
from ag2video_torch.models.layers import Conv, Dense, Embed, avg_pool_3x3s2
from ag2video_torch.models.normalization import NormConv
from ag2video_torch.ops.rasterize import boxes_to_layout_batch

# padw = ceil((4 - 1) / 2) = 2 on each side (reference discriminator.py:364).
PAD = ((2, 2), (2, 2))


class NLayerActionDiscriminator(nn.Module):
    """PatchGAN: k4 conv stack with stride 2 (stride 1 on the last two),
    norm_D NormConvs, leaky-relu; returns every intermediate activation (for
    feature matching) and the patch logits last, in fp32."""

    def __init__(self, in_features: int, ndf: int = 64, n_layers_D: int = 4,
                 norm_D: str = "spectralinstance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_layers_D = n_layers_D
        nf = ndf
        self.model0 = Conv(in_features, nf, 4, 2, dtype=dtype, padding=PAD)
        for n in range(1, n_layers_D):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers_D - 1 else 2
            setattr(self, f"model{n}", NormConv(nf_prev, nf, norm_D, 4,
                                                stride, PAD, dtype))
        setattr(self, f"model{n_layers_D}",
                Conv(nf, 1, 4, 1, dtype=dtype, padding=PAD))

    def forward(self, x: torch.Tensor,
                train: bool = False) -> List[torch.Tensor]:
        x = F.leaky_relu(self.model0(x), 0.2)
        feats = [x]
        for n in range(1, self.n_layers_D):
            x = F.leaky_relu(getattr(self, f"model{n}")(x, train), 0.2)
            feats.append(x)
        feats.append(getattr(self, f"model{self.n_layers_D}")(x).float())
        return feats


class _ActionGCNStep(nn.Module):
    """One timestep of the recurrent action GCN (reference get_obj_vecs loop
    body, discriminator.py:283-311): (obj_vecs, boxes, action vecs, edges,
    indicators) -> new obj_vecs."""

    def __init__(self, embedding_dim: int, gconv_dim: int,
                 gconv_hidden_dim: int, gconv_pooling: str,
                 obj_input_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.obj_vecs_net_0 = Dense(embedding_dim + 4, obj_input_dim,
                                    use_bias=False, dtype=dtype)
        self.obj_vecs_net_1 = Dense(obj_input_dim, obj_input_dim,
                                    use_bias=False, dtype=dtype)
        self.gconv_0 = GraphTripleConv(obj_input_dim, embedding_dim,
                                       gconv_dim, gconv_dim, gconv_hidden_dim,
                                       gconv_pooling, dtype)
        self.gconv_1 = GraphTripleConv(gconv_dim, gconv_dim, gconv_dim,
                                       gconv_dim, gconv_hidden_dim,
                                       gconv_pooling, dtype)

    def forward(self, obj_vecs, boxes_t, acts_vecs_t, edges_t, ind_t):
        x = torch.cat([obj_vecs, boxes_t.to(obj_vecs.dtype)], dim=-1)
        x = torch.relu(self.obj_vecs_net_0(x))
        x = torch.relu(self.obj_vecs_net_1(x))
        pred_vecs = acts_vecs_t
        x, pred_vecs = self.gconv_0(x, pred_vecs, edges_t, ind_t)
        x, pred_vecs = self.gconv_1(x, pred_vecs, edges_t, ind_t)
        return x


class MultiscaleActionDiscriminator(nn.Module):
    """Reference MultiscaleActionDiscriminator (discriminator.py:212-353)."""

    def __init__(self, vocab: Dict[str, Any], embedding_dim: int = 128,
                 gconv_dim: int = 128, gconv_hidden_dim: int = 512,
                 gconv_pooling: str = "avg", mlp_normalization: str = "none",
                 num_D: int = 2, n_layers_D: int = 4, ndf: int = 64,
                 norm_D: str = "spectralinstance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        # mlp_normalization: read and never used, as in the JAX package.
        if embedding_dim != gconv_dim:
            raise ValueError("the recurrent GCN carries its output as its "
                             "input: embedding_dim must equal gconv_dim")
        self.vocab = vocab
        self.num_D = num_D
        num_attr = len(vocab["attributes"])
        cards = {a: max(t.values()) + 1
                 for a, t in vocab["attributes"].items()}
        obj_input_dim = num_attr * embedding_dim
        self.attribute_embedding = AttributeEmbeddings(cards, embedding_dim,
                                                       dtype=dtype)
        self.pre_obj_vecs_net_0 = Dense(obj_input_dim, embedding_dim,
                                        use_bias=False, dtype=dtype)
        self.pre_obj_vecs_net_1 = Dense(embedding_dim, embedding_dim,
                                        use_bias=False, dtype=dtype)
        self.acts_embeddings = Embed(len(vocab["action_idx_to_name"]),
                                     embedding_dim, dtype)
        self.gcn_step = _ActionGCNStep(embedding_dim, gconv_dim,
                                       gconv_hidden_dim, gconv_pooling,
                                       obj_input_dim, dtype)
        self.fc_objs_vecs = Dense(obj_input_dim + gconv_dim, 2 * gconv_dim,
                                  dtype=dtype)
        for i in range(num_D):
            setattr(self, f"discriminator_{i}", NLayerActionDiscriminator(
                3 + 2 * gconv_dim, ndf, n_layers_D, norm_D, dtype))

    def _acts_inputs(self, actions_data: Dict[str, torch.Tensor]):
        """Per-timestep action embeddings, edges and indicators from the
        layout model's actions_data (reference discriminator.py:274-300)."""
        tt = actions_data["temporal_triplets"]        # (B, F, A, 3) int
        rel_t = actions_data["relative_timesteps"]     # (B, F, A)
        locs = actions_data["locs"]                    # (B, F, A, 2)
        pad_act = self.vocab["action_name_to_idx"]["__padding__"]
        acts_vecs = self.acts_embeddings(tt[..., 1])
        tail = torch.cat([locs, rel_t[..., None]], dim=-1).to(acts_vecs.dtype)
        acts_vecs = torch.cat([acts_vecs[..., :-3], tail], dim=-1)
        edges = torch.stack([tt[..., 0], tt[..., 2]], dim=-1)
        return acts_vecs, edges, tt[..., 1] != pad_act

    def forward(self, img: torch.Tensor, objs: torch.Tensor,
                layout_boxes: torch.Tensor,
                actions_data: Dict[str, torch.Tensor], train: bool = False,
                img2: Optional[torch.Tensor] = None):
        """img (B, T, H, W, 3), objs (B, O, A), layout_boxes (B, T, O, 4),
        actions_data (F >= T frames) -> per-scale feature lists; with img2,
        (features of img, features of img2)."""
        B, T, H, W, _ = img.shape

        # --- recurrent action GCN over time (get_obj_vecs) ---
        att = self.attribute_embedding(objs)
        x = torch.relu(self.pre_obj_vecs_net_0(att))
        x = torch.relu(self.pre_obj_vecs_net_1(x))
        acts_vecs, edges, ind = self._acts_inputs(actions_data)
        seq = []
        for t in range(T):
            x = self.gcn_step(x, layout_boxes[:, t], acts_vecs[:, t],
                              edges[:, t], ind[:, t])
            seq.append(x)
        obj_vecs = torch.stack(seq, dim=1)  # (B, T, O, gconv_dim)

        # --- rasterize the action-conditioned features (:319-338) ---
        att_t = att[:, None].expand(B, T, *att.shape[1:])
        fused = self.fc_objs_vecs(torch.cat([att_t, obj_vecs.to(att.dtype)],
                                            dim=-1))
        obj_mask = remove_dummy_objects_mask(objs)
        seg = boxes_to_layout_batch(
            fused, layout_boxes[:, :T], H, W,
            mask=obj_mask[:, None].expand(B, T, objs.shape[1]))

        imgs = (img,) if img2 is None else (img, img2)
        x = torch.cat([torch.cat([im.to(seg.dtype), seg], dim=-1)
                       for im in imgs], dim=0)
        x = x.reshape(len(imgs) * B * T, *x.shape[2:])

        results = []
        for i in range(self.num_D):
            results.append(getattr(self, f"discriminator_{i}")(x, train))
            if i + 1 < self.num_D:
                x = avg_pool_3x3s2(x)
        if img2 is None:
            return results
        n = B * T
        return ([[f[:n] for f in feats] for feats in results],
                [[f[n:] for f in feats] for feats in results])
