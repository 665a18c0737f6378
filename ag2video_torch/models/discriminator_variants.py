"""Further discriminator families (port of
ag2video_tpu/models/discriminator_variants.py; reference discriminator.py:
16-209, 403-608), defined upstream beside the default action discriminator
and run by no default entry point:

* NLayerDiscriminatorTM / MultiscaleDiscriminatorT: PatchGANs over the
  frames of a clip stacked on the channel axis (channel c + 3 * t).
* MultiscaleDiscriminator: a layout-conditioned PatchGAN. The attribute
  embeddings are rasterized into the boxes by
  `ops.rasterize.boxes_to_layout_batch` (the CUDA kernel on the card, the
  plain version on the CPU) and concatenated after the frames.
* AcAttDiscriminator / AcCropDiscriminator: per-object crop discriminators
  (`ops.crop.crop_bbox_batch`) with an auxiliary attribute classifier per
  attribute family.

Every (frame, object) slot is computed; illegal slots are excluded by
weighting, never by boolean indexing. Each forward takes `train`
explicitly; it is passed to the spectral norms (and SpecCNN's norms).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ag2video_torch.models.discriminator import NLayerActionDiscriminator
from ag2video_torch.models.embeddings import AttributeEmbeddings
from ag2video_torch.models.generator import remove_dummy_objects_mask
from ag2video_torch.models.layers import (Dense, SpecCNN, avg_pool_3x3s2,
                                          global_avg_pool)
from ag2video_torch.ops.crop import crop_bbox_batch
from ag2video_torch.ops.rasterize import boxes_to_layout_batch


def _cardinalities(vocab: Dict[str, Any]) -> Dict[str, int]:
    return {a: max(t.values()) + 1 for a, t in vocab["attributes"].items()}


def stack_frames(frames: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, H, W, T * C), channel c + C * t (the JAX
    package's moveaxis(1, -2))."""
    B, T, H, W, C = frames.shape
    return frames.movedim(1, -2).reshape(B, H, W, T * C)


def _multiscale(x: torch.Tensor, discs,
                train: bool) -> List[List[torch.Tensor]]:
    """Run each PatchGAN of `discs` on `x`, pooling between scales."""
    results = []
    for i, d in enumerate(discs):
        results.append(d(x, train))
        if i + 1 < len(discs):
            x = avg_pool_3x3s2(x)
    return results


class NLayerDiscriminatorTM(nn.Module):
    """Temporal PatchGAN over a stacked window of `n_frames` RGB frames
    (reference discriminator.py:16-59)."""

    def __init__(self, n_frames: int, ndf: int = 64, n_layers_D: int = 4,
                 norm_D: str = "spectralinstance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.patch = NLayerActionDiscriminator(3 * n_frames, ndf, n_layers_D,
                                               norm_D, dtype)

    def forward(self, frames: torch.Tensor,
                train: bool = False) -> List[torch.Tensor]:
        return self.patch(stack_frames(frames), train)


class MultiscaleDiscriminatorT(nn.Module):
    """num_D temporal PatchGANs at pooled scales (reference :62-89)."""

    def __init__(self, n_frames: int, num_D: int = 2, ndf: int = 64,
                 n_layers_D: int = 4, norm_D: str = "spectralinstance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            setattr(self, f"discriminator_{i}", NLayerActionDiscriminator(
                3 * n_frames, ndf, n_layers_D, norm_D, dtype))

    def forward(self, frames: torch.Tensor,
                train: bool = False) -> List[List[torch.Tensor]]:
        return _multiscale(stack_frames(frames), [
            getattr(self, f"discriminator_{i}") for i in range(self.num_D)],
            train)


class MultiscaleDiscriminator(nn.Module):
    """Layout-conditioned multiscale PatchGAN (reference :161-209): the
    attribute embeddings (the shared FC always on) rasterized into the
    boxes of every frame, concatenated after the frames, frames folded into
    the batch; no action GCN."""

    def __init__(self, vocab: Dict[str, Any], embedding_dim: int = 128,
                 num_D: int = 2, ndf: int = 64, n_layers_D: int = 4,
                 norm_D: str = "spectralinstance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        cards = _cardinalities(vocab)
        self.num_D = num_D
        self.attribute_embedding = AttributeEmbeddings(
            cards, embedding_dim, dtype=dtype, use_attr_fc_gen=True)
        for i in range(num_D):
            setattr(self, f"discriminator_{i}", NLayerActionDiscriminator(
                3 + len(cards) * embedding_dim, ndf, n_layers_D, norm_D,
                dtype))

    def forward(self, img: torch.Tensor, objs: torch.Tensor,
                layout_boxes: torch.Tensor,
                train: bool = False) -> List[List[torch.Tensor]]:
        """img (B, T, H, W, 3), objs (B, O, A), layout_boxes (B, T, O, 4)
        -> per-scale lists of per-layer features, the patch logits last."""
        B, T, H, W, _ = img.shape
        att = self.attribute_embedding(objs)
        # Dense: the kernel takes (N, O, D) contiguous, and at B = 1 the
        # frames of an expanded view would fold into a strided one.
        att_t = att[:, None].expand(B, T, *att.shape[1:]).contiguous()
        obj_mask = remove_dummy_objects_mask(objs)
        seg = boxes_to_layout_batch(
            att_t, layout_boxes, H, W,
            mask=obj_mask[:, None].expand(layout_boxes.shape[:-1]))
        x = torch.cat([img.to(seg.dtype), seg], dim=-1)
        x = x.reshape(B * T, *x.shape[2:])
        return _multiscale(x, [getattr(self, f"discriminator_{i}")
                               for i in range(self.num_D)], train)


class AcAttDiscriminator(nn.Module):
    """Crop classifier (reference :448-499): SpecCNN, global average pool,
    a 1024-wide Dense, then the real/fake score and one classifier per
    attribute family, whose cross-entropies (log-softmax in fp32) are the
    auxiliary loss: a mean over the weighted crops, the weight sum clipped
    to at least 1."""

    def __init__(self, vocab: Dict[str, Any],
                 arch: str = "C4-64-2,C4-128-2,C4-256-2",
                 normalization: str = "none", activation: str = "relu",
                 padding: str = "same",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cards = _cardinalities(vocab)
        self.cnn = SpecCNN(arch, normalization, activation, padding,
                           dtype=dtype)
        self.proj = Dense(SpecCNN.out_channels(arch), 1024, dtype=dtype)
        self.real_classifier = Dense(1024, 1, dtype=dtype)
        for fam, n in self.cards.items():
            setattr(self, f"obj_classifier_{fam}", Dense(1024, n,
                                                         dtype=dtype))

    def forward(self, crops: torch.Tensor, attr_ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """crops (N, h, w, 3); attr_ids (N, A); mask (N,) weights ->
        (real scores (N, 1) fp32, auxiliary loss)."""
        vec = self.proj(global_avg_pool(self.cnn(crops, train)))
        real_scores = self.real_classifier(vec)
        if mask is None:
            mask = torch.ones(crops.shape[0], device=crops.device)
        mask = mask.float()
        denom = torch.clamp(mask.sum(), min=1.0)
        ac_loss = 0.0
        for k, fam in enumerate(self.cards):
            logits = getattr(self, f"obj_classifier_{fam}")(vec)
            logp = F.log_softmax(logits.float(), dim=-1)
            ce = -logp.gather(-1, attr_ids[:, k:k + 1].long())[:, 0]
            ac_loss = ac_loss + (ce * mask).sum() / denom
        return real_scores.float(), ac_loss


class AcCropDiscriminator(nn.Module):
    """Object-crop discriminator (reference :502-531): every object cropped
    from every frame at `object_size`, then scored and classified."""

    def __init__(self, vocab: Dict[str, Any], object_size: int = 32,
                 arch: str = "C4-64-2,C4-128-2,C4-256-2",
                 normalization: str = "none", activation: str = "relu",
                 padding: str = "same",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.object_size = object_size
        self.att_discriminator = AcAttDiscriminator(
            vocab, arch, normalization, activation, padding, dtype)

    def forward(self, imgs: torch.Tensor, objs: torch.Tensor,
                boxes: torch.Tensor, train: bool = False):
        """imgs (B, T, H, W, 3); objs (B, O, A); boxes (B, T, O, 4) ->
        (real scores (B*T*O, 1), auxiliary loss, crops (B, T, O, s, s, 3),
        legality mask (B*T*O,))."""
        B, T = imgs.shape[:2]
        O, A = objs.shape[1:]
        crops, legal = crop_bbox_batch(imgs, boxes, self.object_size,
                                       mask=remove_dummy_objects_mask(objs))
        flat_mask = legal.reshape(-1)
        flat_attr = objs[:, None].expand(B, T, O, A).reshape(-1, A)
        scores, ac_loss = self.att_discriminator(
            crops.reshape(-1, *crops.shape[3:]), flat_attr, flat_mask, train)
        return scores, ac_loss, crops, flat_mask
