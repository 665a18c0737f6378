"""The plain reference of AG2Video's generation path, in fp32.

A straightforward PyTorch implementation of the model that the benchmark
times: two action-graph rollouts (`acts_to_boxes`, `acts_to_objs`), then the
autoregressive frame loop (flow network, warp, layout frontend, SPADE
generator), in eval mode (running statistics, one spectral power iteration
per kernel from the stored `u`). It imports nothing of the program: it is
written from the published architecture (arXiv:2006.15327 and its code,
github.com/roeiherz/AG2Video) in the layout the port uses, so the
benchmark's seeded weights load into both by the same state-dict names.

Departures from the program that change no value: no cached spectral
kernels, no fused SPADE convs, the dense layout computed by its closed form
(an einsum of coverage maps and object vectors, never a CUDA kernel).

Precision. Every tensor is fp32. `prec` names the precision of the
operands of each contraction (conv, linear, einsum, embedding table):
None computes them in fp32 (call it with TF32 off); "bfloat16" rounds
both operands to bf16 before an fp32 contraction: the plain computation at
the configuration's precision, whose gap from fp32 is the seed's rounding
scale; and "float8_e4m3fn" rounds both operands to e4m3 with a per-tensor
scale: the control, one precision below the configuration's bf16.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

APPEARANCE_DIM = 384   # appearance-embedding width (reference generator.py:16)
TILE = 8               # the rasterizer's tile (reference models/layout.py:52)
FP8_MAX = 448.0        # largest finite float8_e4m3fn


def q(t: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    """`t` as a contraction operand in precision `prec` (see the module
    docstring); fp32 out."""
    t = t.float()
    if prec is None:
        return t
    if prec == "bfloat16":
        return t.to(torch.bfloat16).float()
    if prec != "float8_e4m3fn":
        raise ValueError(f"unknown reference precision {prec!r}")
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA 'SAME' padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
         prec: Optional[str], stride: int = 1) -> torch.Tensor:
    """'SAME' conv of channels-last x (N, H, W, C) by an OIHW kernel."""
    H, W = x.shape[1:3]
    k = w.shape[-1]
    (t, bo), (l, r) = same_pad(H, k, stride), same_pad(W, k, stride)
    # Contiguous NCHW: cuDNN's fp32 kernels without TF32 are far slower on
    # a channels-last input.
    xn = F.pad(q(x, prec).permute(0, 3, 1, 2).contiguous(), (l, r, t, bo))
    y = F.conv2d(xn, q(w, prec).contiguous(),
                 None if b is None else b.float(), stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_transpose(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], prec: Optional[str],
                   stride: int = 2) -> torch.Tensor:
    """XLA's 'SAME' transposed conv (no kernel flip) of channels-last x by
    the program's (I, O, kh, kw) layout, which holds XLA's kernel flipped:
    torch's transposed conv flips it back; the crop takes XLA's window."""
    k = w.shape[-1]
    pad_len = k + stride - 2
    low = k - 1 if stride > k - 1 else -(-pad_len // 2)
    off = k - 1 - low
    H, W = x.shape[1:3]
    y = F.conv_transpose2d(q(x, prec).permute(0, 3, 1, 2).contiguous(),
                           q(w, prec).contiguous(),
                           None if b is None else b.float(), stride=stride)
    y = y[:, :, off:off + stride * H, off:off + stride * W]
    return y.permute(0, 2, 3, 1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-3).repeat_interleave(2, dim=-2)


def resize_nearest(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    """Nearest resize of (..., H, W, C): source index floor(dst * in / out)."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = hw
    iy = torch.floor(torch.arange(Ho, device=x.device, dtype=torch.float32)
                     * (H / Ho)).long()
    ix = torch.floor(torch.arange(Wo, device=x.device, dtype=torch.float32)
                     * (W / Wo)).long()
    return x.index_select(-3, iy).index_select(-2, ix)


class Dense(nn.Module):
    def __init__(self, fin: int, fout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None

    def forward(self, x, prec):
        return F.linear(q(x, prec), q(self.weight, prec),
                        None if self.bias is None else self.bias.float())


class Embed(nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, d))

    def forward(self, idx, prec):
        return F.embedding(idx.long(), q(self.weight, prec))


class Conv(nn.Module):
    def __init__(self, fin: int, fout: int, k: int = 3, bias: bool = True,
                 stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fout, fin, k, k))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None
        self.stride = stride

    def forward(self, x, prec, weight=None):
        w = self.weight if weight is None else weight
        return conv(x, w, self.bias, prec, self.stride)


class ConvTranspose(nn.Module):
    def __init__(self, fin: int, fout: int, k: int = 3, bias: bool = True,
                 stride: int = 2):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fin, fout, k, k))
        self.bias = nn.Parameter(torch.empty(fout)) if bias else None
        self.stride = stride

    def forward(self, x, prec, weight=None):
        w = self.weight if weight is None else weight
        return conv_transpose(x, w, self.bias, prec, self.stride)


class MLP(nn.Module):
    """Dense layers with relu between them (and after the last unless
    `final_relu` is False)."""

    def __init__(self, fin: int, dims: Sequence[int], final_relu=True):
        super().__init__()
        self.n = len(dims)
        for i, (a, b) in enumerate(zip([fin, *dims], dims)):
            setattr(self, f"dense_{i}", Dense(a, b))
        self.final_relu = final_relu

    def forward(self, x, prec):
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x, prec)
            if i < self.n - 1 or self.final_relu:
                x = torch.relu(x)
        return x


# -- norms ------------------------------------------------------------------

def normalize(x, mean, var, eps, weight=None, bias=None):
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    return y if bias is None else y + bias


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the last axis (running statistics)."""

    def __init__(self, c: int, affine: bool = True, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c)) if affine else None
        self.bias = nn.Parameter(torch.empty(c)) if affine else None
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def forward(self, x):
        return normalize(x, self.running_mean, self.running_var, self.eps,
                         self.weight, self.bias)


class GroupNorm(nn.Module):
    """Per-sample statistics over H, W and the channels of each group (one
    group per channel: the instance norm); no parameters."""

    def __init__(self, groups: Optional[int] = None, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps

    def forward(self, x):
        N, H, W, C = x.shape
        G = self.groups or C
        xg = x.reshape(N, H, W, G, C // G)
        mean = xg.mean((1, 2, 4), keepdim=True)
        var = xg.var((1, 2, 4), unbiased=False, keepdim=True)
        return ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)


BATCH_KINDS = ("batch", "sync_batch", "syncbatch")


def subnorm(kind: str, c: int) -> nn.Module:
    if kind in BATCH_KINDS:
        return BatchNorm(c)
    if kind == "instance":
        return GroupNorm(None)
    raise ValueError(f"unknown norm {kind!r}")


def split_norm(norm: str):
    spectral = norm.startswith("spectral")
    sub = norm[len("spectral"):] if spectral else norm
    return spectral, sub, sub not in ("", "none")


def l2n(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralWeight(nn.Module):
    """Spectral normalisation state of one kernel: `u` (1, out) and `sigma`
    (not read in eval mode). One power iteration from `u` on the kernel
    viewed as (kh*kw*in, out) (XLA's HWIO layout; a Dense kernel as
    (in, out); a transposed kernel through its unflipped layout)."""

    def __init__(self, c: int, transposed: bool = False):
        super().__init__()
        self.register_buffer("u", torch.zeros(1, c))
        self.register_buffer("sigma", torch.ones(()))
        self.transposed = transposed

    def forward(self, weight):
        if weight.dim() == 2:
            m = weight.float().t()
        elif self.transposed:
            m = weight.float().flip(2, 3).permute(2, 3, 0, 1)
        else:
            m = weight.float().permute(2, 3, 1, 0)
        m = m.reshape(-1, m.shape[-1])
        v = l2n(self.u.float() @ m.t())
        u = l2n(v @ m)
        sigma = ((v @ m) @ u.t())[0, 0]
        return weight.float() / torch.where(sigma != 0, sigma,
                                            torch.ones_like(sigma))


class SNConv(nn.Module):
    def __init__(self, fin, fout, k=3, bias=True, spectral=True):
        super().__init__()
        self.conv = Conv(fin, fout, k, bias)
        self.spectral = SpectralWeight(fout) if spectral else None

    def forward(self, x, prec):
        w = None if self.spectral is None else self.spectral(self.conv.weight)
        return self.conv(x, prec, w)


class NormConv(nn.Module):
    """(Spectral) conv, then an optional batch or instance norm; the conv
    has a bias only without the norm."""

    def __init__(self, fin, fout, norm, k=3, stride=1, transpose=False):
        super().__init__()
        spectral, sub, has_sub = split_norm(norm)
        cls = ConvTranspose if transpose else Conv
        self.conv = cls(fin, fout, k, bias=not has_sub, stride=stride)
        self.spectral = SpectralWeight(fout, transpose) if spectral else None
        self.norm = subnorm(sub, fout) if has_sub else None

    def forward(self, x, prec):
        w = None if self.spectral is None else self.spectral(self.conv.weight)
        x = self.conv(x, prec, w)
        return x if self.norm is None else self.norm(x)


class ParamFreeNorm(nn.Module):
    def __init__(self, kind: str, c: int):
        super().__init__()
        if kind in BATCH_KINDS:
            self.bn = BatchNorm(c, affine=False)
        elif kind == "instance":
            self.bn = GroupNorm(None, eps=1e-5)
        elif kind == "group":
            self.bn = GroupNorm(min(32, c))
        else:
            raise ValueError(f"unknown param-free norm {kind!r}")

    def forward(self, x):
        return self.bn(x)


class SPADE(nn.Module):
    """norm(x) * (1 + gamma(seg)) + beta(seg), gamma and beta from a shared
    relu conv of the segmap resized to x (nhidden 128)."""

    def __init__(self, config_text: str, nc: int, label_nc: int):
        super().__init__()
        m = re.search(r"spade(\D+)(\d)x\d", config_text)
        if not m:
            raise ValueError(f"bad SPADE config {config_text!r}")
        ks = int(m.group(2))
        self.param_free_norm = ParamFreeNorm(m.group(1), nc)
        self.mlp_shared = Conv(label_nc, 128, ks)
        self.mlp_gamma = Conv(128, nc, ks)
        self.mlp_beta = Conv(128, nc, ks)

    def forward(self, x, seg, prec):
        actv = torch.relu(self.mlp_shared(
            resize_nearest(seg, x.shape[1:3]), prec))
        return (self.param_free_norm(x) * (1 + self.mlp_gamma(actv, prec))
                + self.mlp_beta(actv, prec))


class SPADEResnetBlock(nn.Module):
    def __init__(self, fin, fout, label_nc, norm_G):
        super().__init__()
        fmid = min(fin, fout)
        spectral = "spectral" in norm_G
        cfg = norm_G.replace("spectral", "")
        self.shortcut = fin != fout
        if self.shortcut:
            self.norm_s = SPADE(cfg, fin, label_nc)
            self.conv_s = SNConv(fin, fout, 1, bias=False, spectral=spectral)
        self.norm_0 = SPADE(cfg, fin, label_nc)
        self.conv_0 = SNConv(fin, fmid, 3, spectral=spectral)
        self.norm_1 = SPADE(cfg, fmid, label_nc)
        self.conv_1 = SNConv(fmid, fout, 3, spectral=spectral)

    def forward(self, x, seg, prec):
        x_s = self.conv_s(self.norm_s(x, seg, prec), prec) \
            if self.shortcut else x
        dx = self.conv_0(lrelu(self.norm_0(x, seg, prec)), prec)
        dx = self.conv_1(lrelu(self.norm_1(dx, seg, prec)), prec)
        return x_s + dx


class SPADEGenerator(nn.Module):
    def __init__(self, label_nc, ngf, norm_G, num_upsampling_layers,
                 aspect_ratio):
        super().__init__()
        nf = ngf
        self.mode, self.aspect_ratio = num_upsampling_layers, aspect_ratio
        self.fc = Conv(label_nc, 16 * nf, 3)
        self.blocks = [("head_0", 16 * nf, 16 * nf),
                       ("G_middle_0", 16 * nf, 16 * nf),
                       ("G_middle_1", 16 * nf, 16 * nf),
                       ("up_0", 16 * nf, 8 * nf), ("up_1", 8 * nf, 4 * nf),
                       ("up_2", 4 * nf, 2 * nf), ("up_3", 2 * nf, nf)]
        if num_upsampling_layers == "most":
            self.blocks.append(("up_4", nf, nf // 2))
        for name, fin, fout in self.blocks:
            setattr(self, name, SPADEResnetBlock(fin, fout, label_nc, norm_G))
        self.conv_img = Conv(self.blocks[-1][2], 3, 3)

    def forward(self, seg, prec):
        H, W = seg.shape[1:3]
        n_up = {"normal": 5, "more": 6, "most": 7}[self.mode]
        sw = W // (2 ** n_up)
        sh = round(sw / self.aspect_ratio)
        x = self.fc(resize_nearest(seg, (sh, sw)), prec)
        ups = {"G_middle_0": True,
               "G_middle_1": self.mode in ("more", "most"),
               "up_0": True, "up_1": True, "up_2": True, "up_3": True,
               "up_4": True}
        for name, _, _ in self.blocks:
            if name != "head_0" and ups[name]:
                x = upsample2(x)
            x = getattr(self, name)(x, seg, prec)
        return torch.tanh(self.conv_img(lrelu(x), prec))


class FlowResBlock(nn.Module):
    def __init__(self, c, norm):
        super().__init__()
        spectral = "spectral" in norm
        sub = norm.replace("spectral", "")
        if "batch" in sub:
            self.bn_0, self.bn_1 = BatchNorm(c), BatchNorm(c)
        elif "instance" in sub:
            self.bn_0, self.bn_1 = GroupNorm(None), GroupNorm(None)
        else:
            self.bn_0 = self.bn_1 = None
        self.conv_0 = SNConv(c, c, 3, spectral=spectral)
        self.conv_1 = SNConv(c, c, 3, spectral=spectral)

    def forward(self, x, prec):
        dx = x if self.bn_0 is None else self.bn_0(x)
        dx = self.conv_0(lrelu(dx), prec)
        dx = dx if self.bn_1 is None else self.bn_1(dx)
        return x + self.conv_1(lrelu(dx), prec)


class FlowsGenerator(nn.Module):
    """Encoder (stride-2 NormConvs), residual blocks, decoder (nearest x2 +
    NormConv, or a transposed NormConv), flow and weight heads; with
    `skip_first` the first conv is the frontend's and x is its output."""

    def __init__(self, fin, nff, n_blocks, nd, norm, flow_multiplier,
                 deconv, skip_first):
        super().__init__()
        ch = [min(1024, nff * 2 ** i) for i in range(nd + 1)]
        self.nd, self.n_blocks, self.mult = nd, n_blocks, flow_multiplier
        self.deconv, self.skip_first = deconv, skip_first
        if not skip_first:
            self.down_0 = NormConv(fin, nff, norm, 3)
        for i in range(nd):
            setattr(self, f"down_{i + 1}",
                    NormConv(ch[i], ch[i + 1], norm, 3, stride=2))
        for i in range(n_blocks):
            setattr(self, f"res_{i}", FlowResBlock(ch[nd], norm))
        for j, i in enumerate(reversed(range(nd))):
            setattr(self, f"up_{j}",
                    NormConv(ch[i + 1], ch[i], norm, 3,
                             stride=2 if deconv else 1, transpose=deconv))
        self.conv_flow = Conv(ch[0], 2, 3)
        self.conv_w = Conv(ch[0], 1, 3)

    def forward(self, x, prec):
        if not self.skip_first:
            x = lrelu(self.down_0(x, prec))
        for i in range(self.nd):
            x = lrelu(getattr(self, f"down_{i + 1}")(x, prec))
        for i in range(self.n_blocks):
            x = getattr(self, f"res_{i}")(x, prec)
        for j in range(self.nd):
            if not self.deconv:
                x = upsample2(x)
            x = lrelu(getattr(self, f"up_{j}")(x, prec))
        return self.conv_flow(x, prec) * self.mult


class FactorizedNormConv(nn.Module):
    """The frontend conv of the factorized configuration: the conv of
    [layout window, image channels] by one spectrally normalised kernel,
    its layout part taken in the object basis (the layout is a sum over
    objects of coverage x vector, so each (frame, object) gets its kernel
    projected on its vector and convolved with its coverage map), then the
    norm (or a bias)."""

    def __init__(self, fout, norm, seg_dim, n_frames, img_ch, k=3):
        super().__init__()
        spectral, sub, has_sub = split_norm(norm)
        self.seg_dim, self.n_frames, self.k = seg_dim, n_frames, k
        self.weight = nn.Parameter(
            torch.empty(fout, n_frames * seg_dim + img_ch, k, k))
        if spectral:
            self.register_buffer("u", torch.zeros(fout))
        else:
            self.u = None
        self.norm = subnorm(sub, fout) if has_sub else None
        self.bias = None if has_sub else nn.Parameter(torch.empty(fout))

    def kernel(self):
        if self.u is None:
            return self.weight.float()
        k2 = self.weight.float().permute(2, 3, 1, 0)
        k2 = k2.reshape(-1, k2.shape[-1])
        u = self.u.float()
        v = k2 @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = k2.t() @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
        v = k2 @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        return self.weight.float() / torch.einsum("k,kf,f->", v, k2, u)

    def forward(self, cov_win, vecs_win, img, prec):
        """cov_win (B, nF, O, H, W), vecs_win (B, nF, O, D), img
        (B, H, W, c) -> (B, H, W, fout)."""
        B, nF, O, H, W = cov_win.shape
        k, ks = self.kernel(), self.k
        seg_ch = self.n_frames * self.seg_dim
        k_seg = k[:, :seg_ch].reshape(-1, nF, self.seg_dim, ks * ks)
        wk = torch.einsum("fnds,bnod->bnosf", q(k_seg, prec),
                          q(vecs_win, prec)).reshape(B, nF * O * ks * ks, -1)
        shifts = F.unfold(q(cov_win, prec).reshape(B, nF * O, H, W), ks,
                          padding=ks // 2)        # (B, nF*O*ks*ks, H*W)
        x = torch.bmm(shifts.transpose(1, 2), q(wk, prec))
        x = x.reshape(B, H, W, -1) + conv(img, k[:, seg_ch:], None, prec)
        return x + self.bias if self.norm is None else self.norm(x)


# -- layout ------------------------------------------------------------------

def box_coverage(boxes, H, W, mask):
    """(..., O, 4) xywh boxes, (..., O) validity -> (..., O, H, W) coverage
    of the 8x8 tile grid-sampled into each box: a unit-wide ramp at each
    tile edge (bilinear sampling of a constant tile, in closed form)."""
    boxes = boxes.float()
    dev = boxes.device
    x0, y0, ww, hh = (boxes[..., i:i + 1] for i in range(4))
    xs = torch.arange(W, dtype=torch.float32, device=dev) / torch.tensor(
        float(max(W - 1, 1)), device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev) / torch.tensor(
        float(max(H - 1, 1)), device=dev)
    safe_w = torch.where(ww == 0, torch.ones_like(ww), ww)
    safe_h = torch.where(hh == 0, torch.ones_like(hh), hh)
    px = (xs - x0) / safe_w * (TILE - 1.0)
    py = (ys - y0) / safe_h * (TILE - 1.0)
    wx = torch.clamp(torch.minimum(px + 1.0, TILE - px), 0.0, 1.0)
    wy = torch.clamp(torch.minimum(py + 1.0, TILE - py), 0.0, 1.0)
    valid = (ww != 0) & (hh != 0) & (mask[..., None] > 0)
    wx = torch.where(valid, wx, torch.zeros_like(wx))
    return wy[..., :, None] * wx[..., None, :]


def warp(image, flow):
    """Bilinear, border-padded warp of (B, H, W, C) by a pixel flow."""
    B, H, W, _ = flow.shape
    dev = flow.device
    xs = torch.linspace(-1.0, 1.0, W, device=dev)
    ys = torch.linspace(-1.0, 1.0, H, device=dev)
    base = torch.stack([xs[None, :].expand(H, W), ys[:, None].expand(H, W)],
                       -1)
    scale = torch.tensor([(W - 1.0) / 2.0, (H - 1.0) / 2.0], device=dev)
    grid = base + flow.float() / scale
    return F.grid_sample(image.permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="border",
                         align_corners=False).permute(0, 2, 3, 1)


class AttributeEmbeddings(nn.Module):
    def __init__(self, cards: Sequence[int], d: int):
        super().__init__()
        self.n = len(cards)
        for k, c in enumerate(cards):
            setattr(self, f"att_emb_{k}", Embed(c, d))
        self.attribute_fc_gen = Dense(self.n * d, self.n * d) \
            if self.n > 1 else None

    def forward(self, objs, prec):
        out = torch.cat([getattr(self, f"att_emb_{k}")(objs[..., k], prec)
                         for k in range(self.n)], -1)
        return out if self.attribute_fc_gen is None else \
            self.attribute_fc_gen(out, prec)


class GraphTripleConv(nn.Module):
    def __init__(self, obj_in, pred_in, obj_out, pred_out, hidden, pooling):
        super().__init__()
        self.H, self.Dp, self.pooling = hidden, pred_out, pooling
        self.net1 = MLP(2 * obj_in + pred_in,
                        [hidden, 2 * hidden + pred_out])
        self.net2 = MLP(hidden, [hidden, obj_out])

    def forward(self, obj, pred, edges, ind, prec):
        O, D = obj.shape[1], obj.shape[2]
        s, o = edges[..., 0].long(), edges[..., 1].long()
        cur_s = torch.gather(obj, 1, s[..., None].expand(-1, -1, D))
        cur_o = torch.gather(obj, 1, o[..., None].expand(-1, -1, D))
        t = self.net1(torch.cat([cur_s, pred, cur_o], -1), prec)
        H, Dp = self.H, self.Dp
        new_s, new_p, new_o = t[..., :H], t[..., H:H + Dp], t[..., H + Dp:]
        ar = torch.arange(O, device=obj.device)
        w = ind.float()[..., None]
        oh_s = (s[..., None] == ar).float() * w
        oh_o = (o[..., None] == ar).float() * w
        pooled = (torch.einsum("beo,beh->boh", oh_s, q(new_s, prec))
                  + torch.einsum("beo,beh->boh", oh_o, q(new_o, prec)))
        if self.pooling == "avg":
            pooled = pooled / torch.clamp(oh_s.sum(1) + oh_o.sum(1),
                                          min=1.0)[..., None]
        return self.net2(pooled, prec), new_p


class LayoutStep(nn.Module):
    def __init__(self, emb, gdim, ghid, glayers, pooling, obj_in):
        super().__init__()
        self.obj_vecs_net_0 = Dense(obj_in + 4, obj_in, bias=False)
        self.obj_vecs_net_1 = Dense(obj_in, obj_in, bias=False)
        self.n_layers = glayers
        fin = obj_in
        for i in range(glayers):
            setattr(self, f"gconv_{i}", GraphTripleConv(
                fin, emb if i == 0 else gdim, gdim, gdim, ghid, pooling))
            fin = gdim
        self.box_net = MLP(gdim, [ghid, 4], final_relu=False)

    def forward(self, boxes, obj_embed, pred, edges, ind, prec):
        x = torch.relu(self.obj_vecs_net_0(
            torch.cat([obj_embed, boxes], -1), prec))
        obj = torch.relu(self.obj_vecs_net_1(x, prec))
        for i in range(self.n_layers):
            obj, pred = getattr(self, f"gconv_{i}")(obj, pred, edges, ind,
                                                    prec)
        return boxes + self.box_net(obj, prec), obj


class Acts2LayoutModel(nn.Module):
    """The action-graph rollout: per step t = 1..T-1, object embeddings and
    the previous boxes through the GCN over spatial and time-gated action
    edges; the box head adds a delta to the previous boxes."""

    def __init__(self, vocab, emb, gdim, ghid, glayers, pooling,
                 only_temporal):
        super().__init__()
        cards = vocab["attributes"]
        self.pad_pred = vocab["pred_padding"]
        self.pad_act = vocab["action_padding"]
        self.gdim, self.only_temporal = gdim, only_temporal
        self.attribute_embedding = AttributeEmbeddings(cards, emb)
        self.acts_embeddings = Embed(vocab["actions"], emb)
        if not only_temporal:
            self.pred_embeddings = Embed(vocab["predicates"], emb)
        self.step = LayoutStep(emb, gdim, ghid, glayers, pooling,
                               len(cards) * emb)

    def forward(self, objs, triplets, actions, boxes_gt, prec):
        B, T = triplets.shape[:2]
        O = objs.shape[1]
        obj_embed = self.attribute_embedding(objs, prec)
        a_id = actions[..., 1]
        f1, f2 = actions[..., 3].float(), actions[..., 4].float()
        t = torch.arange(T, dtype=torch.float32,
                         device=actions.device)[None, :, None]
        rel = (t / T) * (f2 - f1 + 1e-6)[:, None, :] + f1[:, None, :]
        live = (rel >= 0) & (rel <= 1)
        gated = torch.where(live, a_id[:, None, :],
                            torch.full_like(rel, float(self.pad_act))).long()
        ex = lambda c: actions[:, None, :, c].expand(gated.shape)  # noqa
        acts = self.acts_embeddings(gated, prec)
        acts = torch.cat([acts[..., :-3],
                          torch.stack([ex(5), ex(6), rel], -1)], -1)
        act_edges = torch.stack([ex(0), ex(2)], -1).long()
        act_ind = gated != self.pad_act
        if self.only_temporal:
            edges, pred, ind = act_edges, acts, act_ind
        else:
            p = triplets[..., 1]
            edges = torch.cat([torch.stack([triplets[..., 0],
                                            triplets[..., 2]], -1).long(),
                               act_edges], 2)
            pred = torch.cat([self.pred_embeddings(p, prec), acts], 2)
            ind = torch.cat([p != self.pad_pred, act_ind], 2)
        boxes = boxes_gt[:, 0].float()
        boxes_seq, vecs = [boxes], [obj_embed.new_zeros(B, O, self.gdim)]
        for i in range(1, T):
            boxes, obj = self.step(boxes, obj_embed, pred[:, i], edges[:, i],
                                   ind[:, i], prec)
            boxes_seq.append(boxes)
            vecs.append(obj)
        return torch.stack(vecs, 1), torch.stack(boxes_seq, 1)


class FrameStep(nn.Module):
    def __init__(self, seg_ch, semantic_nc, m):
        super().__init__()
        nG = m["n_frames_G"]
        self.nG = nG
        self.factorized = m["factorized_frontend"]
        win = nG * seg_ch
        norm_F = m["norm_F"]
        if self.factorized:
            self.flow_down_0 = FactorizedNormConv(
                m["nff"], norm_F, seg_ch, nG, 3 * (nG - 1))
            self.conv_dim_in = FactorizedNormConv(
                semantic_nc, norm_F, seg_ch, nG, 3)
        else:
            self.conv_dim_in = NormConv(win + 3, semantic_nc, norm_F, 3)
        self.flows_network = FlowsGenerator(
            win + 3 * (nG - 1), m["nff"], m["n_blocks_F"],
            m["n_downsample_F"], norm_F, m["flow_multiplier"],
            m["flow_deconv"], self.factorized)
        self.netG = SPADEGenerator(semantic_nc, m["ngf"], m["norm_G"],
                                   m["num_upsampling_layers"],
                                   m["aspect_ratio"])

    def forward(self, prev, window, prec):
        if self.factorized:
            cov, vecs = window
            feat = lrelu(self.flow_down_0(cov, vecs, prev, prec))
        else:
            feat = torch.cat([window, prev], -1)
        flow = self.flows_network(feat, prec)
        last = prev[..., -3:]
        warped = warp(last, flow)
        if self.factorized:
            x = self.conv_dim_in(cov, vecs, warped, prec)
        else:
            x = self.conv_dim_in(torch.cat([window, warped], -1), prec)
        img = self.netG(lrelu(x), prec) + warped
        new_prev = torch.cat([prev[..., 3:], img], -1) if self.nG > 2 \
            else img
        return new_prev, img


class Layout2VidGenerator(nn.Module):
    def __init__(self, vocab, m, semantic_nc):
        super().__init__()
        cards = vocab["attributes"]
        per = APPEARANCE_DIM // len(cards)
        self.attribute_embedding = AttributeEmbeddings(cards, per)
        self.nG = m["n_frames_G"]
        self.factorized = m["factorized_frontend"]
        self.frame_step = FrameStep(per * len(cards) + m["gconv_dim"],
                                    semantic_nc, m)

    def forward(self, imgs, objs, obj_vecs, boxes, prec):
        B, T, H, W, _ = imgs.shape
        nc = self.nG - 1
        att = self.attribute_embedding(objs, prec)
        vecs = torch.cat([att[:, None].expand(B, T, *att.shape[1:]),
                          obj_vecs], -1)
        mask = (objs[..., 0] != 0)[:, None].expand(boxes.shape[:-1])
        cov = box_coverage(boxes, H, W, mask)
        if not self.factorized:
            # Every frame's dense layout, in its closed form.
            seg = torch.einsum("btohw,btod->bthwd", cov, q(vecs, prec))
        prev = torch.cat([imgs[:, i].float() for i in range(nc)], -1)
        out = [imgs[:, i].float() for i in range(nc)]
        for t in range(T - nc):
            if self.factorized:
                window = (cov[:, t:t + nc + 1], vecs[:, t:t + nc + 1])
            else:
                window = torch.cat([seg[:, t + i] for i in range(nc + 1)],
                                   -1)
            prev, img = self.frame_step(prev, window, prec)
            out.append(img)
        return torch.stack(out, 1)


class AG2VideoReference(nn.Module):
    """forward(imgs, objs, triplets, actions, boxes) -> (imgs_pred
    (B, T, H, W, 3), boxes_pred (B, T, O, 4)): the generation call, both
    rollouts from the first frame's boxes, frames from the predicted
    boxes."""

    def __init__(self, config: Dict[str, Any], prec: Optional[str] = None):
        super().__init__()
        vocab, m = config["vocab"], config["model"]
        self.prec = prec
        self.coupled = m["coupled_motion_apperance"]
        args = (vocab, m["embedding_dim"], m["gconv_dim"],
                m["gconv_hidden_dim"], m["gconv_num_layers"],
                m["gconv_pooling"], m["only_temporal"])
        self.acts_to_boxes = Acts2LayoutModel(*args)
        if not self.coupled:
            self.acts_to_objs = Acts2LayoutModel(*args)
        semantic_nc = m["generator_cond_nc"] or \
            len(vocab["attributes"]) * m["embedding_dim"]
        self.layout_to_video = Layout2VidGenerator(vocab, m, semantic_nc)

    def forward(self, imgs, objs, triplets, actions, boxes):
        p = self.prec
        obj_vecs, boxes_pred = self.acts_to_boxes(objs, triplets, actions,
                                                  boxes, p)
        if not self.coupled:
            obj_vecs, _ = self.acts_to_objs(objs, triplets, actions, boxes, p)
        return (self.layout_to_video(imgs, objs, obj_vecs, boxes_pred, p),
                boxes_pred)


def param_kinds(model: nn.Module) -> Dict[str, Tuple[str, float]]:
    """state-dict name -> (kind, fan_in) of every tensor of `model`, for the
    seeded weights: 'matrix' (a Dense, conv or transposed-conv kernel;
    fan_in its inputs), 'embed' (a table; fan_in its width), 'scale' (a
    norm's weight), 'bias', 'mean' / 'var' (running statistics), 'u' (a
    power-iteration vector) and 'sigma'."""
    kinds = {}
    for prefix, mod in model.named_modules():
        pre = prefix + "." if prefix else ""
        for name, t in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            if isinstance(mod, Embed):
                kind = ("embed", float(t.shape[1]))
            elif name == "weight" and isinstance(mod, BatchNorm):
                kind = ("scale", 0.0)
            elif name == "weight":
                fan = t.shape[0] if isinstance(mod, ConvTranspose) \
                    else t.shape[1]
                kind = ("matrix", float(fan * math.prod(t.shape[2:])))
            elif name in ("bias", "u", "sigma"):
                kind = (name, 0.0)
            elif name == "running_mean":
                kind = ("mean", 0.0)
            elif name == "running_var":
                kind = ("var", 0.0)
            else:
                raise ValueError(f"no seeded rule for {pre}{name}")
            kinds[pre + name] = kind
    return kinds
