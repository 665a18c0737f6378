"""The three loss modes of the reference LossModel (port of
ag2video_tpu/losses/loss_model.py; reference
models/spade_models/loss_model.py:13-149), as functions of (config, batch,
model outputs, discriminator call). Each returns a dict of named scalar
losses with 'total_loss' (or 'total_img_loss').

Batches are dicts of tensors: imgs (B, T, H, W, 3), objs (B, O, A),
boxes (B, T, O, 4), triplets (B, T, E, 3), actions (B, A, 7).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ag2video_torch.losses.gan import multiscale_gan_loss
from ag2video_torch.losses.perceptual import vgg_loss
from ag2video_torch.ops.warp import resample

DApply = Callable[..., List[List[torch.Tensor]]]


def smooth_l1(x: torch.Tensor, y: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (F.smooth_l1_loss, reduction='none')."""
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _slice_actions_data(actions_data: Dict[str, torch.Tensor], ncond: int,
                        detach: bool = False) -> Dict[str, torch.Tensor]:
    """Drop the conditioning frames from every F-axis entry (reference
    loss_model.py:70)."""
    return {k: (v.detach() if detach else v)[:, ncond:]
            for k, v in actions_data.items()}


def compute_graph_loss(cfg, batch: Dict[str, torch.Tensor],
                       boxes_pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Masked smooth-L1 on the boxes x bbox_pred_loss_weight (reference
    loss_model.py:41-60); the mean is over ALL elements, masked included,
    as the reference normalises it."""
    boxes, objs = batch["boxes"], batch["objs"]
    per_elem = smooth_l1(boxes_pred[:, 1:].float(), boxes[:, 1:].float()) \
        * cfg.bbox_pred_loss_weight  # (B, T-1, O, 4)
    real = (objs.sum(-1) != 0).float()  # (B, O): any attribute nonzero
    loss = (per_elem * real[:, None, :, None]).mean()
    return {"bbox_pred": loss, "total_loss": loss}


def compute_generator_loss(cfg, batch: Dict[str, torch.Tensor],
                           model_out: Dict[str, Any], d_apply: DApply,
                           vgg_features: Optional[Callable] = None
                           ) -> Dict[str, torch.Tensor]:
    """Hinge GAN + feature matching + flow-warp L1 + VGG perceptual
    (reference loss_model.py:62-103). Fake and real go through D as one
    batched call when feature matching is on; the real features carry no
    gradient."""
    imgs, objs, boxes = batch["imgs"], batch["objs"], batch["boxes"]
    imgs_pred, flows_pred = model_out["imgs_pred"], model_out["flows_pred"]
    ncond = cfg.n_frames_G - 1
    rel_imgs = imgs[:, ncond:]
    rel_boxes = boxes[:, ncond:]
    rel_imgs_pred = imgs_pred[:, ncond:]
    rel_actions = _slice_actions_data(model_out["actions_data"], ncond)

    losses: Dict[str, torch.Tensor] = {}
    if cfg.no_ganFeat_loss:
        pred_fake = d_apply(rel_imgs_pred, objs, rel_boxes, rel_actions)
    else:
        pred_fake, pred_real = d_apply(rel_imgs_pred, objs, rel_boxes,
                                       rel_actions, img2=rel_imgs)
    losses["GAN_Img"] = multiscale_gan_loss(
        pred_fake, True, False, cfg.gan_mode) \
        * cfg.discriminator_img_loss_weight

    if not cfg.no_ganFeat_loss:
        num_D = len(pred_fake)
        feat = 0.0
        for i in range(num_D):
            for j in range(len(pred_fake[i]) - 1):  # the logits excluded
                feat = feat + (pred_fake[i][j].float()
                               - pred_real[i][j].detach().float()
                               ).abs().mean() * (cfg.lambda_feat / num_D)
        losses["GAN_Feat"] = feat

    # Flow-warp loss: frame t-1 warped by the predicted flow -> frame t
    # (reference loss_model.py:89-97).
    src = imgs[:, ncond - 1:-1]
    flw = flows_pred[:, ncond - 1:-1]
    tgt = imgs[:, ncond:]
    warped = resample(src.reshape(-1, *src.shape[2:]),
                      flw.reshape(-1, *flw.shape[2:]))
    losses["loss_F_Warp"] = (warped - tgt.reshape(warped.shape)).abs() \
        .mean() * cfg.lambda_F_warp

    if not cfg.no_vgg_loss and vgg_features is not None:
        losses["VGG"] = vgg_loss(vgg_features, rel_imgs_pred, rel_imgs) \
            * cfg.lambda_vgg

    losses["total_loss"] = sum(losses.values())
    return losses


def compute_discriminator_loss(cfg, batch: Dict[str, torch.Tensor],
                               model_out: Dict[str, Any], d_apply: DApply
                               ) -> Dict[str, torch.Tensor]:
    """Hinge real/fake on the detached predictions, one batched D call
    (reference loss_model.py:105-132)."""
    imgs, objs, boxes = batch["imgs"], batch["objs"], batch["boxes"]
    ncond = cfg.n_frames_G - 1
    rel_imgs = imgs[:, ncond:]
    rel_boxes = boxes[:, ncond:]
    rel_imgs_pred = model_out["imgs_pred"][:, ncond:].detach()
    rel_actions = _slice_actions_data(model_out["actions_data"], ncond,
                                      detach=True)
    pred_fake, pred_real = d_apply(rel_imgs_pred, objs, rel_boxes,
                                   rel_actions, img2=rel_imgs)
    losses = {
        "D_img_fake": multiscale_gan_loss(pred_fake, False, True,
                                          cfg.gan_mode),
        "D_img_real": multiscale_gan_loss(pred_real, True, True,
                                          cfg.gan_mode),
    }
    losses["total_img_loss"] = losses["D_img_fake"] + losses["D_img_real"]
    return losses
