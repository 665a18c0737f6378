"""Training state (port of ag2video_tpu/train/state.py): the generator-side
model, the discriminator, the frozen VGG, and the reference's three Adams.

The reference (scripts/train.py:365-368) builds `optimizer_graph` over the
`acts_to_boxes` parameters and `optimizer_generator` over the rest of the
model; the discriminator owns a third Adam (meta_models.py:70). Each is a
`torch.optim.Adam` with betas (beta1, 0.999) and eps 1e-8, whose update
rule is optax.adam's; the learning rate follows the JAX package's
schedule (`learning_rate`) by the optimizer's own count of updates, as
optax counts them.

With `param_dtype="bfloat16"` (the JAX package's `with_fp32_master`) the
floating parameters of the model and the discriminator are bf16, and each
Adam holds an fp32 master copy of its parameters: it steps the master with
the gradients taken to fp32, then writes bf16(master) into the live
parameter, so after every update the live parameters are exactly
bf16(master). The BN statistics, the spectral `u` / sigma (buffers) and the
frozen VGG stay fp32. A full checkpoint saves the masters with the Adam
states.

A light resume re-initialises the three Adams from the restored weights
(`reset_optimizers`): the moments and the schedule's count start at 0, as
the JAX light resume's fresh optax states do, and each master starts as
fp32(restored parameter) (a stale master would overwrite the restored
weights at the first update: the JAX package's ADVICE r4 fault).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import torch
from torch import nn

from ag2video_torch.config import Config
from ag2video_torch.models.discriminator import MultiscaleActionDiscriminator
from ag2video_torch.models.meta import AG2VideoModel
from ag2video_torch.models.vgg import (RANDOM_WEIGHTS_WARNING, VGG19Features,
                                       load_vgg19_arrays, vgg19_from_arrays)
from ag2video_torch.weights import init_params

log = logging.getLogger(__name__)

GRAPH_KEY = "acts_to_boxes"


def learning_rate(cfg: Config, count: int, scale_decayed: float = 1.0
                  ) -> float:
    """The JAX package's `_lr_schedule` at update `count`: constant, or
    with niter_decay > 0 constant for `niter` updates, then a linear decay
    to zero over niter_decay, scaled by `scale_decayed` (the TTUR split)
    once decaying."""
    base = cfg.learning_rate
    if cfg.niter_decay <= 0:
        return base
    frac = min(max((count - cfg.niter) / max(cfg.niter_decay, 1), 0.0), 1.0)
    return base * (1.0 - frac) * (scale_decayed if frac > 0 else 1.0)


class ScheduledAdam(torch.optim.Adam):
    """torch.optim.Adam whose learning rate is `learning_rate(cfg, count,
    scale_decayed)`, `count` being the number of updates taken so far.

    master=True: the Adam's own parameters are fp32 masters of the given
    (bf16) `live` parameters (see the module docstring); `step` reads the
    live gradients and writes the live parameters, and `state_dict` /
    `load_state_dict` carry the masters under "master"."""

    def __init__(self, params, cfg: Config, scale_decayed: float = 1.0,
                 master: bool = False):
        params = list(params)
        self.live = params if master else None
        if master:
            params = [p.detach().float().clone() for p in params]
        super().__init__(params, lr=cfg.learning_rate,
                         betas=(cfg.beta1, 0.999), eps=1e-8)
        self.cfg, self.scale_decayed, self.count = cfg, scale_decayed, 0

    @property
    def masters(self):
        return self.param_groups[0]["params"] if self.live is not None \
            else None

    def live_params(self):
        """The model's parameters this Adam updates, in its own order."""
        return self.live if self.live is not None \
            else [p for g in self.param_groups for p in g["params"]]

    def step(self, closure=None):
        lr = learning_rate(self.cfg, self.count, self.scale_decayed)
        for group in self.param_groups:
            group["lr"] = lr
        if self.live is not None:
            for p, m in zip(self.live, self.masters):
                m.grad = None if p.grad is None else p.grad.float()
        out = super().step(closure)
        if self.live is not None:
            with torch.no_grad():
                for p, m in zip(self.live, self.masters):
                    p.copy_(m)  # bf16(master), rounded to nearest even
        self.count += 1
        return out

    def state_dict(self):
        out = super().state_dict()
        if self.live is not None:
            out["master"] = list(self.masters)
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        masters = state_dict.pop("master", None)
        if (masters is None) != (self.live is None):
            raise KeyError(f"optimizer state with masters: "
                           f"{masters is not None}; optimizer with masters:"
                           f" {self.live is not None}")
        super().load_state_dict(state_dict)
        if masters is not None:
            with torch.no_grad():
                for m, saved in zip(self.masters, masters):
                    m.copy_(saved)


def make_optimizers(cfg: Config, model: nn.Module, disc: nn.Module):
    """(graph, generator, discriminator) Adams: `acts_to_boxes.*` only, the
    rest of the model, and D; TTUR halves G's and doubles D's decayed rate;
    fp32 masters with param_dtype='bfloat16'."""
    master = param_master(cfg)
    ttur = not cfg.no_TTUR
    graph = [p for n, p in model.named_parameters()
             if n.split(".")[0] == GRAPH_KEY]
    gen = [p for n, p in model.named_parameters()
           if n.split(".")[0] != GRAPH_KEY]
    return (ScheduledAdam(graph, cfg, master=master),
            ScheduledAdam(gen, cfg, 0.5 if ttur else 1.0, master=master),
            ScheduledAdam(disc.parameters(), cfg, 2.0 if ttur else 1.0,
                          master=master))


def param_master(cfg: Config) -> bool:
    """Whether the parameters are bf16 with fp32 masters."""
    if cfg.param_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"param_dtype {cfg.param_dtype!r}: float32 or "
                         f"bfloat16")
    return cfg.param_dtype == "bfloat16"


def to_param_dtype(module: nn.Module, cfg: Config) -> nn.Module:
    """The floating parameters of `module` in bf16 when param_dtype is
    bfloat16 (buffers untouched); returns it."""
    if param_master(cfg):
        for p in module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.bfloat16)
    return module


def reset_optimizers(state: "TrainState", cfg: Config) -> None:
    """Fresh Adams over `state`'s (restored) weights: no moments, count 0."""
    state.opt_graph, state.opt_gen, state.opt_d = make_optimizers(
        cfg, state.model, state.disc)


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


@dataclasses.dataclass
class TrainState:
    step: int
    epoch: int
    model: AG2VideoModel                   # params + batch_stats / spectral
    disc: MultiscaleActionDiscriminator   # params + spectral
    vgg: Optional[VGG19Features]           # frozen; None without the loss
    opt_graph: ScheduledAdam
    opt_gen: ScheduledAdam
    opt_d: ScheduledAdam
    skipped_nan: int = 0


def make_discriminator(cfg: Config, vocab: Dict[str, Any],
                       device: torch.device) -> MultiscaleActionDiscriminator:
    """The configured discriminator, seeded from cfg.seed + 1, on `device`
    (fp32 parameters)."""
    disc = MultiscaleActionDiscriminator(
        vocab, embedding_dim=cfg.embedding_dim, gconv_dim=cfg.gconv_dim,
        gconv_hidden_dim=cfg.gconv_hidden_dim,
        gconv_pooling=cfg.gconv_pooling,
        mlp_normalization=cfg.mlp_normalization, num_D=cfg.num_D,
        n_layers_D=cfg.n_layers_D, ndf=cfg.ndf, norm_D=cfg.norm_D,
        dtype=getattr(torch, cfg.compute_dtype) if cfg.compute_dtype
        else None)
    return init_params(disc, cfg.seed + 1).to(device)


def create_train_state(cfg: Config, vocab: Dict[str, Any],
                       device: torch.device) -> TrainState:
    """Seeded models (the model from cfg.seed, D from cfg.seed + 1, a random
    VGG from cfg.seed + 2) on `device`, their parameters in
    cfg.param_dtype, and fresh optimizers."""
    model = AG2VideoModel(cfg, vocab, device=device)
    disc = make_discriminator(cfg, vocab, device)
    to_param_dtype(model, cfg)
    to_param_dtype(disc, cfg)
    vgg_arrays = load_vgg19_arrays()
    vgg = None
    if vgg_arrays is not None:
        vgg = vgg19_from_arrays(vgg_arrays)
    elif not cfg.no_vgg_loss:
        log.warning(RANDOM_WEIGHTS_WARNING)
        vgg = init_params(VGG19Features(), cfg.seed + 2)
    if vgg is not None:
        vgg = vgg.to(device)
    opt_graph, opt_gen, opt_d = make_optimizers(cfg, model, disc)
    return TrainState(step=0, epoch=0, model=model, disc=disc, vgg=vgg,
                      opt_graph=opt_graph, opt_gen=opt_gen, opt_d=opt_d)
