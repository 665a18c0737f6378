"""The plain reference of AG2Video's training iteration, in fp32.

One iteration, as the published code trains (arXiv:2006.15327; its
scripts/train.py:425-493 and models/spade_models/loss_model.py): a G step,
a D step and a graph step, each followed by its own Adam.

* G step: the generator in train mode, teacher forced (every generated
  frame is fed the real frame before it, and the layouts are drawn from
  the real boxes, so the generated frames of a clip fold into one batch):
  batch statistics over that batch with the running averages moved
  (`ra = m * ra + (1 - m) * stat`, m = 0.99, 0.9 in SPADE's param-free
  norm, the biased variance stored), one power iteration of every
  spectral norm from its stored `u`, the new `u` (and sigma) stored. The
  losses against the frozen discriminator (its stored spectral state
  read, not written): hinge GAN, feature matching on every layer but the
  logits (the real features carry no gradient), the L1 of the real frame
  before each generated one warped by its predicted flow against the real
  frame, and the VGG19 perceptual L1 of relu1_1..relu5_1 with weights
  1/32..1. Their gradient, then the generator's Adam over every weight
  but the box rollout's (`acts_to_boxes`).
* D step: the discriminator in train mode on the generated frames of the
  same forward, detached, and the real frames, in one batched call; the
  hinge losses, their gradient, the discriminator's Adam.
* graph step: the box rollout alone on longer clips, the smooth-L1 of the
  predicted boxes of frames 1.. against the real ones over every element
  (padded objects masked, the mean over all), the rollout's Adam.

Adam: betas (beta1, 0.999), eps 1e-8, bias-corrected, a weight without a
gradient left as it is. The discriminator: a two-layer GCN over the
action edges run recurrently over the frames from the attribute
embeddings, fused with them, drawn into a dense layout by the boxes'
coverage maps (the closed form, never a kernel), stacked with the frames
and judged by `num_D` PatchGANs (k4 convs padded 2 on each side, spectral
norm and instance norm between the first and the last) on successively
3x3/2-average-pooled scales.

It imports nothing of the program and builds on
`benchmark/reference/generation.py`, whose modules it runs in train mode:
`trainable` gives its batch norms, spectral norms and object-basis convs
their train-mode forward (`module.training`).

Departures from the published description, none changing a value the
program computes: the layouts in the object basis where the configuration
takes the factorized frontend (as generation.py); the variance taken by
its two-pass formula (the program takes E[x^2] - E[x]^2); the VGG19 on the
benchmark's seeded weights, not ImageNet's (those would be a download);
the learning rate constant (niter_decay 0). No random draw happens inside
a step at this configuration (no noise, no crop), so nothing is shared
with the program's run but the weights and the batches.

Precision: every tensor is fp32; `prec` (generation.py's) rounds the
operands of each contraction in the forward pass, and in the backward the
gradient that reaches each rounded operand, with a per-tensor scale of its
own (a cast of the gradient through the forward's scale would flush it to
zero in fp8). The backward contracts the rounded gradients with the
rounded operands the forward saved, accumulating in fp32. "bfloat16" is
the plain computation at the configuration's precision; "float8_e4m3fn"
the control: fp8 training as it is done, e4m3 forward operands and e5m2
gradients, each with a per-tensor scale.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import generation as gen

ADAM_BETA2, ADAM_EPS = 0.999, 1e-8
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
VGG_TAPS = (0, 2, 4, 8, 12)           # relu1_1 .. relu5_1
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)
D_PAD = 2                             # ceil((4 - 1) / 2)
GROUPS = ("graph", "gen", "disc")     # the three Adams


E5M2_MAX = 57344.0     # largest finite float8_e5m2


def e5m2(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to e5m2 with a per-tensor scale; fp32 out."""
    scale = t.abs().amax().clamp(min=1e-30) / E5M2_MAX
    return (t / scale).to(torch.float8_e5m2).float() * scale


class _Round(torch.autograd.Function):
    """generation.q's rounding of a tensor in the forward pass, and of its
    gradient (with its own per-tensor scale) in the backward: to bf16 for
    "bfloat16", to e5m2 for "float8_e4m3fn" (fp8 training's format for
    gradients, whose range they need)."""

    @staticmethod
    def forward(ctx, t, prec, base):
        ctx.prec, ctx.base = prec, base
        return base(t, prec)

    @staticmethod
    def backward(ctx, g):
        if ctx.prec == "float8_e4m3fn":
            return e5m2(g), None, None
        return ctx.base(g, ctx.prec), None, None


class rounding:
    """Inside the block, generation.q rounds the operands of each
    contraction in the forward pass and their gradients in the backward
    (see the module docstring)."""

    def __enter__(self):
        self.base = base = gen.q

        def q(t, prec):
            if prec is None:
                return t.float()
            return _Round.apply(t.float(), prec, base)
        gen.q = q

    def __exit__(self, *exc):
        gen.q = self.base


# -- train-mode forwards of generation.py's modules ------------------------

class TrainBatchNorm(gen.BatchNorm):
    momentum = 0.99

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = x.var(dims, unbiased=False)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        return gen.normalize(x, mean, var, self.eps, self.weight, self.bias)


def power_iteration(m: torch.Tensor, u: torch.Tensor):
    """One iteration on the (-1, out) matrix m from u (1, out): (v, u),
    neither carrying a gradient."""
    with torch.no_grad():
        md = m.detach()
        v = gen.l2n(u.float() @ md.t())
        return v, gen.l2n(v @ md)


class TrainSpectralWeight(gen.SpectralWeight):
    def forward(self, weight):
        if weight.dim() == 2:
            m = weight.float().t()
        elif self.transposed:
            m = weight.float().flip(2, 3).permute(2, 3, 0, 1)
        else:
            m = weight.float().permute(2, 3, 1, 0)
        m = m.reshape(-1, m.shape[-1])
        v, u = power_iteration(m, self.u)
        sigma = ((v @ m) @ u.t())[0, 0]
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return weight.float() / torch.where(sigma != 0, sigma,
                                            torch.ones_like(sigma))


class TrainFactorizedNormConv(gen.FactorizedNormConv):
    def kernel(self):
        if self.u is None:
            return self.weight.float()
        k2 = self.weight.float().permute(2, 3, 1, 0)
        k2 = k2.reshape(-1, k2.shape[-1])
        unit = lambda x: x / (torch.linalg.vector_norm(x) + 1e-12)  # noqa
        with torch.no_grad():
            kd = k2.detach()
            u = unit(kd.t() @ unit(kd @ self.u.float()))
            v = unit(kd @ u)
            if self.training:
                self.u.copy_(u)
        return self.weight.float() / torch.einsum("k,kf,f->", v, k2, u)


TRAIN_FORWARDS = {gen.BatchNorm: TrainBatchNorm,
                  gen.SpectralWeight: TrainSpectralWeight,
                  gen.FactorizedNormConv: TrainFactorizedNormConv}


def trainable(module: nn.Module) -> nn.Module:
    """Give every batch norm, spectral norm and object-basis conv of
    `module` its train-mode forward (used while `module.training`);
    SPADE's param-free batch norms move their averages at 0.9."""
    for m in module.modules():
        cls = TRAIN_FORWARDS.get(type(m))
        if cls is not None:
            m.__class__ = cls
    for m in module.modules():
        if isinstance(m, gen.ParamFreeNorm) and \
                isinstance(m.bn, TrainBatchNorm):
            m.bn.momentum = 0.9
    return module


# -- discriminator and VGG -------------------------------------------------

class PadConv(gen.Conv):
    """A conv padded `pad` on every side (the PatchGAN's k4 convs)."""

    def __init__(self, fin, fout, k=4, bias=True, stride=1, pad=D_PAD):
        super().__init__(fin, fout, k, bias, stride)
        self.pad = pad

    def forward(self, x, prec, weight=None):
        w = self.weight if weight is None else weight
        p = self.pad
        xn = F.pad(gen.q(x, prec).permute(0, 3, 1, 2).contiguous(),
                   (p, p, p, p))
        y = F.conv2d(xn, gen.q(w, prec).contiguous(),
                     None if self.bias is None else self.bias.float(),
                     stride=self.stride)
        return y.permute(0, 2, 3, 1)


class PadNormConv(nn.Module):
    """PadConv without a bias, spectrally normalised, then the norm."""

    def __init__(self, fin, fout, norm, stride):
        super().__init__()
        spectral, sub, has_sub = gen.split_norm(norm)
        self.conv = PadConv(fin, fout, 4, not has_sub, stride)
        self.spectral = TrainSpectralWeight(fout) if spectral else None
        self.norm = gen.subnorm(sub, fout) if has_sub else None

    def forward(self, x, prec):
        w = None if self.spectral is None else self.spectral(self.conv.weight)
        x = self.conv(x, prec, w)
        return x if self.norm is None else self.norm(x)


class PatchGAN(nn.Module):
    def __init__(self, fin, ndf, n_layers, norm):
        super().__init__()
        self.n = n_layers
        nf = ndf
        self.model0 = PadConv(fin, nf, 4, True, 2)
        for i in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"model{i}", PadNormConv(
                nf_prev, nf, norm, 1 if i == n_layers - 1 else 2))
        setattr(self, f"model{n_layers}", PadConv(nf, 1, 4, True, 1))

    def forward(self, x, prec) -> List[torch.Tensor]:
        x = gen.lrelu(self.model0(x, prec))
        feats = [x]
        for i in range(1, self.n):
            x = gen.lrelu(getattr(self, f"model{i}")(x, prec))
            feats.append(x)
        feats.append(getattr(self, f"model{self.n}")(x, prec))
        return feats


class ActionGCNStep(nn.Module):
    def __init__(self, emb, gdim, ghid, pooling, obj_in):
        super().__init__()
        self.obj_vecs_net_0 = gen.Dense(emb + 4, obj_in, bias=False)
        self.obj_vecs_net_1 = gen.Dense(obj_in, obj_in, bias=False)
        self.gconv_0 = gen.GraphTripleConv(obj_in, emb, gdim, gdim, ghid,
                                           pooling)
        self.gconv_1 = gen.GraphTripleConv(gdim, gdim, gdim, gdim, ghid,
                                           pooling)

    def forward(self, obj, boxes, acts, edges, ind, prec):
        x = torch.relu(self.obj_vecs_net_0(torch.cat([obj, boxes], -1),
                                           prec))
        x = torch.relu(self.obj_vecs_net_1(x, prec))
        x, pred = self.gconv_0(x, acts, edges, ind, prec)
        x, _ = self.gconv_1(x, pred, edges, ind, prec)
        return x


def action_clock(actions: torch.Tensor, T: int, pad: int):
    """actions (B, A, 7) [s, a, o, f1, f2, x_end, y_end] over T frames ->
    (action ids gated to the frames their clock covers, else `pad`
    (B, T, A) long; the clock (B, T, A); a column c of the actions over the
    frames)."""
    f1, f2 = actions[..., 3].float(), actions[..., 4].float()
    t = torch.arange(T, dtype=torch.float32,
                     device=actions.device)[None, :, None]
    rel = (t / T) * (f2 - f1 + 1e-6)[:, None, :] + f1[:, None, :]
    live = (rel >= 0) & (rel <= 1)
    gated = torch.where(live, actions[:, None, :, 1],
                        torch.full_like(rel, float(pad))).long()
    return gated, rel, lambda c: actions[:, None, :, c].expand(gated.shape)


class ActionDiscriminator(nn.Module):
    """forward(imgs (B, T, H, W, 3), objs, boxes (B, T, O, 4), actions,
    first, T_all, prec, imgs2) -> per-scale feature lists (logits last),
    and with imgs2 the same of imgs2 from the one batched call. The action
    clock runs over `T_all` frames, of which frames first.. are judged."""

    def __init__(self, vocab, emb, gdim, ghid, pooling, num_D, n_layers,
                 ndf, norm):
        super().__init__()
        cards = vocab["attributes"]
        obj_in = len(cards) * emb
        self.pad_act, self.num_D = vocab["action_padding"], num_D
        self.attribute_embedding = gen.AttributeEmbeddings(cards, emb)
        self.pre_obj_vecs_net_0 = gen.Dense(obj_in, emb, bias=False)
        self.pre_obj_vecs_net_1 = gen.Dense(emb, emb, bias=False)
        self.acts_embeddings = gen.Embed(vocab["actions"], emb)
        self.gcn_step = ActionGCNStep(emb, gdim, ghid, pooling, obj_in)
        self.fc_objs_vecs = gen.Dense(obj_in + gdim, 2 * gdim)
        for i in range(num_D):
            setattr(self, f"discriminator_{i}",
                    PatchGAN(3 + 2 * gdim, ndf, n_layers, norm))

    def forward(self, imgs, objs, boxes, actions, first, T_all, prec,
                imgs2=None):
        B, T, H, W, _ = imgs.shape
        att = self.attribute_embedding(objs, prec)
        x = torch.relu(self.pre_obj_vecs_net_0(att, prec))
        x = torch.relu(self.pre_obj_vecs_net_1(x, prec))
        gated, rel, col = action_clock(actions, T_all, self.pad_act)
        acts = self.acts_embeddings(gated, prec)
        acts = torch.cat([acts[..., :-3],
                          torch.stack([col(5), col(6), rel], -1)], -1)
        edges = torch.stack([col(0), col(2)], -1).long()
        ind = gated != self.pad_act
        seq = []
        for t in range(T):
            f = first + t
            x = self.gcn_step(x, boxes[:, t].float(), acts[:, f], edges[:, f],
                              ind[:, f], prec)
            seq.append(x)
        vecs = torch.cat([att[:, None].expand(B, T, *att.shape[1:]),
                          torch.stack(seq, 1)], -1)
        fused = self.fc_objs_vecs(vecs, prec)
        mask = (objs[..., 0] != 0)[:, None].expand(B, T, objs.shape[1])
        cov = gen.box_coverage(boxes, H, W, mask)
        seg = torch.einsum("btohw,btod->bthwd", cov, gen.q(fused, prec))
        both = (imgs,) if imgs2 is None else (imgs, imgs2)
        x = torch.cat([torch.cat([im.float(), seg], -1) for im in both], 0)
        x = x.reshape(len(both) * B * T, H, W, -1)
        out = []
        for i in range(self.num_D):
            out.append(getattr(self, f"discriminator_{i}")(x, prec))
            if i + 1 < self.num_D:
                # A contiguous NCHW copy: on CUDA (PyTorch 2.11) this pool's
                # backward on a channels-last input returns a wrong input
                # gradient (the forward is right).
                x = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 2, 1,
                                 count_include_pad=False).permute(0, 2, 3, 1)
        if imgs2 is None:
            return out
        n = B * T
        return ([[f[:n] for f in s] for s in out],
                [[f[n:] for f in s] for s in out])


class VGG19(nn.Module):
    """VGG19's convs up to relu5_1: the relu features after convs
    VGG_TAPS; 2x2 max pools."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for c in VGG19_CFG:
            if c == "M":
                continue
            if i > VGG_TAPS[-1]:
                break
            setattr(self, f"conv_{i}", gen.Conv(cin, c, 3))
            cin, i = c, i + 1
        self.n = i

    def forward(self, x, prec) -> List[torch.Tensor]:
        feats, i = [], 0
        for c in VGG19_CFG:
            if i == self.n:
                break
            if c == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
                continue
            x = torch.relu(getattr(self, f"conv_{i}")(x, prec))
            if i in VGG_TAPS:
                feats.append(x)
            i += 1
        return feats


# -- losses ------------------------------------------------------------------

def hinge(preds, real: bool, for_d: bool) -> torch.Tensor:
    """Hinge GAN loss averaged over the scales (their logits last)."""
    total = 0.0
    for scale in preds:
        x = scale[-1].float()
        if not for_d:
            total = total - x.mean()
        elif real:
            total = total - torch.clamp(x - 1, max=0.0).mean()
        else:
            total = total - torch.clamp(-x - 1, max=0.0).mean()
    return total / len(preds)


class Adam:
    """Adam over named weights: betas (beta1, 0.999), eps 1e-8, bias
    corrected per weight by its own count of updates; a weight whose
    gradient is None is left as it is."""

    def __init__(self, named: Sequence[Tuple[str, nn.Parameter]], lr: float,
                 beta1: float):
        self.named, self.lr, self.b1 = list(named), lr, beta1
        self.state: Dict[str, list] = {}

    @torch.no_grad()
    def step(self):
        b1, b2 = self.b1, ADAM_BETA2
        for name, p in self.named:
            if p.grad is None:
                continue
            st = self.state.setdefault(
                name, [0, torch.zeros_like(p), torch.zeros_like(p)])
            st[0] += 1
            t, m, v = st
            g = p.grad
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            m_hat = m / (1 - b1 ** t)
            v_hat = v / (1 - b2 ** t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + ADAM_EPS))


SUPPORTED = dict(gan_mode="hinge", niter_decay=0, param_dtype="float32",
                 bp_prev=False, freeze_graph=False, graph_only=False)


class TrainingReference(nn.Module):
    """The generator (generation.AG2VideoReference in train mode), the
    action discriminator and VGG19, their three Adams, and the iteration.
    `train` holds the cell's training keys (the program's Config names).
    State-dict names are the program's: model.*, disc.*, vgg.*."""

    def __init__(self, config: Dict[str, Any], train: Dict[str, Any],
                 prec: Optional[str] = None):
        super().__init__()
        for k, v in SUPPORTED.items():
            if train.get(k, v) != v:
                raise ValueError(f"the training reference takes {k}={v!r}")
        m, vocab = config["model"], config["vocab"]
        self.train_keys, self.prec = dict(train), prec
        self.ncond = m["n_frames_G"] - 1
        self.factorized = m["factorized_frontend"]
        self.model = trainable(gen.AG2VideoReference(config))
        self.disc = ActionDiscriminator(
            vocab, m["embedding_dim"], m["gconv_dim"], m["gconv_hidden_dim"],
            m["gconv_pooling"], train["num_D"], train["n_layers_D"],
            train["ndf"], train["norm_D"])
        self.vgg = None if train["no_vgg_loss"] else VGG19()
        self.vgg_requires_grad(False)
        self.opts: Dict[str, Adam] = {}
        self.frames: Optional[torch.Tensor] = None

    def vgg_requires_grad(self, on: bool) -> None:
        if self.vgg is not None:
            self.vgg.requires_grad_(on)

    def groups(self) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
        """The weights of each Adam, by state-dict name."""
        model = list(self.model.named_parameters())
        return {"graph": [("model." + n, p) for n, p in model
                          if n.split(".")[0] == "acts_to_boxes"],
                "gen": [("model." + n, p) for n, p in model
                        if n.split(".")[0] != "acts_to_boxes"],
                "disc": [("disc." + n, p)
                         for n, p in self.disc.named_parameters()]}

    def reset_optimizers(self) -> None:
        t = self.train_keys
        self.opts = {g: Adam(named, t["learning_rate"], t["beta1"])
                     for g, named in self.groups().items()}

    # -- forwards ------------------------------------------------------------
    def teacher_forced(self, b):
        """The generator's train forward on the real boxes and frames ->
        (frames (B, T, H, W, 3), the flows of frames ncond.. (B, T-ncond,
        H, W, 2))."""
        p, g = self.prec, self.model.layout_to_video
        imgs, objs, boxes = b["imgs"], b["objs"], b["boxes"]
        model = self.model
        net = model.acts_to_objs if not model.coupled else model.acts_to_boxes
        obj_vecs, _ = net(objs, b["triplets"], b["actions"], boxes, p)
        B, T, H, W, _ = imgs.shape
        nc, n = self.ncond, T - self.ncond
        att = g.attribute_embedding(objs, p)
        vecs = torch.cat([att[:, None].expand(B, T, *att.shape[1:]),
                          obj_vecs], -1)
        mask = (objs[..., 0] != 0)[:, None].expand(boxes.shape[:-1])
        cov = gen.box_coverage(boxes, H, W, mask)
        fold = lambda a: a.reshape(B * n, *a.shape[2:])  # noqa: E731
        if self.factorized:
            window = tuple(fold(torch.stack(
                [a[:, i:i + n] for i in range(nc + 1)], 2))
                for a in (cov, vecs))
        else:
            seg = torch.einsum("btohw,btod->bthwd", cov, gen.q(vecs, p))
            window = fold(torch.cat([seg[:, i:i + n] for i in range(nc + 1)],
                                    -1))
        prev = fold(torch.cat([imgs[:, i:i + n] for i in range(nc)],
                              -1)).float()
        img, flow = self.frame(g.frame_step, prev, window)
        frames = torch.cat([imgs[:, :nc].float(),
                            img.reshape(B, n, H, W, 3)], 1)
        return frames, flow.reshape(B, n, H, W, 2)

    def frame(self, fs, prev, window):
        """generation.FrameStep's forward, returning (frame, flow)."""
        p = self.prec
        if fs.factorized:
            cov, vecs = window
            feat = gen.lrelu(fs.flow_down_0(cov, vecs, prev, p))
        else:
            feat = torch.cat([window, prev], -1)
        flow = fs.flows_network(feat, p)
        warped = gen.warp(prev[..., -3:], flow)
        if fs.factorized:
            x = fs.conv_dim_in(cov, vecs, warped, p)
        else:
            x = fs.conv_dim_in(torch.cat([window, warped], -1), p)
        return fs.netG(gen.lrelu(x), p) + warped, flow

    def generated_frames(self, b, prec: Optional[str]) -> torch.Tensor:
        """The frames the G step's train forward generates from `b` (B,
        T - ncond, H, W, 3) in precision `prec`, no gradient; every buffer
        (running averages, spectral state) left as it was."""
        kept = {n: t.clone() for n, t in self.model.named_buffers()}
        own, self.prec = self.prec, prec
        try:
            self.model.train()
            with torch.no_grad():
                frames, _ = self.teacher_forced(b)
        finally:
            self.prec = own
            with torch.no_grad():
                for n, t in self.model.named_buffers():
                    t.copy_(kept[n])
        return frames[:, self.ncond:]

    def judge(self, fake, b, real=None):
        nc = self.ncond
        return self.disc(fake, b["objs"], b["boxes"][:, nc:], b["actions"],
                         nc, b["imgs"].shape[1], self.prec, imgs2=real)

    def generator_losses(self, b, frames, flows) -> Dict[str, torch.Tensor]:
        t, nc = self.train_keys, self.ncond
        imgs = b["imgs"].float()
        fake, real = frames[:, nc:], imgs[:, nc:]
        out: Dict[str, torch.Tensor] = {}
        if t["no_ganFeat_loss"]:
            pred_fake = self.judge(fake, b)
        else:
            pred_fake, pred_real = self.judge(fake, b, real)
        out["GAN_Img"] = hinge(pred_fake, True, False) \
            * t["discriminator_img_loss_weight"]
        if not t["no_ganFeat_loss"]:
            feat = 0.0
            for sf, sr in zip(pred_fake, pred_real):
                for a, r in zip(sf[:-1], sr[:-1]):
                    feat = feat + (a - r.detach()).abs().mean() \
                        * (t["lambda_feat"] / len(pred_fake))
            out["GAN_Feat"] = feat
        H, W = imgs.shape[2:4]
        src = imgs[:, nc - 1:-1].reshape(-1, H, W, 3)
        warped = gen.warp(src, flows.reshape(-1, H, W, 2))
        out["loss_F_Warp"] = (warped - real.reshape(warped.shape)).abs() \
            .mean() * t["lambda_F_warp"]
        if self.vgg is not None:
            x, y = fake.reshape(-1, H, W, 3), real.reshape(-1, H, W, 3)
            fx = self.vgg(x, self.prec)
            with torch.no_grad():
                fy = self.vgg(y, self.prec)
            vgg = 0.0
            for w, a, r in zip(VGG_WEIGHTS, fx, fy):
                vgg = vgg + w * (a - r).abs().mean()
            out["VGG"] = vgg * t["lambda_vgg"]
        out["total_loss"] = sum(out.values())
        return out

    def discriminator_losses(self, b, frames) -> Dict[str, torch.Tensor]:
        nc = self.ncond
        pred_fake, pred_real = self.judge(frames[:, nc:].detach(), b,
                                          b["imgs"][:, nc:].float())
        out = {"D_img_fake": hinge(pred_fake, False, True),
               "D_img_real": hinge(pred_real, True, True)}
        out["total_img_loss"] = out["D_img_fake"] + out["D_img_real"]
        return out

    def graph_losses(self, b) -> Dict[str, torch.Tensor]:
        _, boxes_pred = self.model.acts_to_boxes(
            b["objs"], b["triplets"], b["actions"], b["boxes"], self.prec)
        per = F.smooth_l1_loss(boxes_pred[:, 1:], b["boxes"][:, 1:].float(),
                               reduction="none", beta=1.0) \
            * self.train_keys["bbox_pred_loss_weight"]
        real = (b["objs"].sum(-1) != 0).float()
        loss = (per * real[:, None, :, None]).mean()
        return {"bbox_pred": loss, "total_loss": loss}

    # -- the iteration -------------------------------------------------------
    def _zero(self, module):
        for p in module.parameters():
            p.grad = None

    def iteration(self, b, graph, update: bool = True):
        """One train step (G step, D step(s)) on `b` and one graph step on
        `graph`, the program's metric names -> (losses, {group: {name:
        the gradient its Adam got first}}); the G step's generated frames
        kept in `self.frames`."""
        losses: Dict[str, torch.Tensor] = {}
        grads: Dict[str, Dict[str, Optional[torch.Tensor]]] = {}

        def took(group):
            grads[group] = {n: None if w.grad is None else w.grad.clone()
                            for n, w in self.groups()[group]}
            if update:
                self.opts[group].step()

        with rounding():
            # G step: the frozen discriminator reads its spectral state.
            self.model.train()
            self.disc.eval()
            self.disc.requires_grad_(False)
            self._zero(self.model)
            frames, flows = self.teacher_forced(b)
            self.frames = frames[:, self.ncond:].detach()
            g = self.generator_losses(b, frames, flows)
            g["total_loss"].backward()
            self.disc.requires_grad_(True)
            took("gen")
            losses.update({f"G/{k}": v.detach() for k, v in g.items()})
            frames = frames.detach()
            # D step(s) on the same forward's frames.
            self.disc.train()
            for i in range(max(self.train_keys["D_steps_per_G"], 1)):
                self._zero(self.disc)
                d = self.discriminator_losses(b, frames)
                d["total_img_loss"].backward()
                if i == 0:
                    took("disc")
                elif update:
                    self.opts["disc"].step()
            losses.update({f"D/{k}": v.detach() for k, v in d.items()})
            # graph step.
            self._zero(self.model)
            gl = self.graph_losses(graph)
            gl["total_loss"].backward()
            took("graph")
            losses.update({f"Graph/{k}": v.detach() for k, v in gl.items()})
        return losses, grads
