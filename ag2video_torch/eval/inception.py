"""InceptionV3 backbone and Inception Score (port of
ag2video_tpu/eval/inception.py).

torchvision's InceptionV3 channels-last, in fp32, with the flax module's
names (`Conv2d_1a_3x3/conv`, `Mixed_5b/branch1x1/bn`, `fc`), so the JAX
package's asset, `assets/inception_v3.npz` (scripts/port_torch_weights.py,
either package's), loads strictly through the weight bridge (weights.py).
`BasicConv` is a conv without bias, BatchNorm with eps 1e-3 and a relu; the
3x3 average pools count the padded zeros (flax's `avg_pool`), the stride-2
max pools are VALID. `pool3` is the 2048-d global average pool.

Without the asset the network holds seeded random weights (`random_init`):
its scores are comparable only within one configuration, and they differ
from the JAX package's random-init scores (flax's `init` at PRNGKey(0)).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ag2video_torch.eval.fid import inception_score_from_probs
from ag2video_torch.eval.layers import (Conv, avg_pool, eval_device,
                                        load_variables, max_pool)
from ag2video_torch.models.layers import Dense
from ag2video_torch.models.normalization import BatchNorm
from ag2video_torch.ops.sampling import resize_bilinear  # noqa: F401
from ag2video_torch.weights import read_asset

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets", "inception_v3.npz",
)


class BasicConv(nn.Module):
    """conv (no bias) + BN(eps=1e-3) + relu (torchvision BasicConv2d)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int], strides: int = 1,
                 padding="VALID"):
        super().__init__()
        self.conv = Conv(in_features, features, kernel, strides, padding,
                         use_bias=False)
        self.bn = BatchNorm(features, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


def _avgpool3(x):
    return avg_pool(x, (3, 3), (1, 1), "SAME")


def _maxpool3s2(x):
    return max_pool(x, (3, 3), (2, 2))


class _Branches(nn.Module):
    """Named BasicConvs, built from (name, in, out, kernel, strides,
    padding) rows."""

    def __init__(self, rows):
        super().__init__()
        for name, cin, cout, k, s, pad in rows:
            setattr(self, name, BasicConv(cin, cout, k, s, pad))

    def chain(self, x, *names):
        for n in names:
            x = getattr(self, n)(x)
        return x


class InceptionA(_Branches):
    def __init__(self, cin: int, pool_features: int):
        super().__init__([
            ("branch1x1", cin, 64, (1, 1), 1, "VALID"),
            ("branch5x5_1", cin, 48, (1, 1), 1, "VALID"),
            ("branch5x5_2", 48, 64, (5, 5), 1, "SAME"),
            ("branch3x3dbl_1", cin, 64, (1, 1), 1, "VALID"),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, "SAME"),
            ("branch3x3dbl_3", 96, 96, (3, 3), 1, "SAME"),
            ("branch_pool", cin, pool_features, (1, 1), 1, "VALID")])

    def forward(self, x):
        return torch.cat([
            self.chain(x, "branch1x1"),
            self.chain(x, "branch5x5_1", "branch5x5_2"),
            self.chain(x, "branch3x3dbl_1", "branch3x3dbl_2",
                       "branch3x3dbl_3"),
            self.chain(_avgpool3(x), "branch_pool")], -1)


class InceptionB(_Branches):
    def __init__(self, cin: int):
        super().__init__([
            ("branch3x3", cin, 384, (3, 3), 2, "VALID"),
            ("branch3x3dbl_1", cin, 64, (1, 1), 1, "VALID"),
            ("branch3x3dbl_2", 64, 96, (3, 3), 1, "SAME"),
            ("branch3x3dbl_3", 96, 96, (3, 3), 2, "VALID")])

    def forward(self, x):
        return torch.cat([
            self.chain(x, "branch3x3"),
            self.chain(x, "branch3x3dbl_1", "branch3x3dbl_2",
                       "branch3x3dbl_3"),
            _maxpool3s2(x)], -1)


class InceptionC(_Branches):
    def __init__(self, cin: int, c7: int):
        super().__init__([
            ("branch1x1", cin, 192, (1, 1), 1, "VALID"),
            ("branch7x7_1", cin, c7, (1, 1), 1, "VALID"),
            ("branch7x7_2", c7, c7, (1, 7), 1, "SAME"),
            ("branch7x7_3", c7, 192, (7, 1), 1, "SAME"),
            ("branch7x7dbl_1", cin, c7, (1, 1), 1, "VALID"),
            ("branch7x7dbl_2", c7, c7, (7, 1), 1, "SAME"),
            ("branch7x7dbl_3", c7, c7, (1, 7), 1, "SAME"),
            ("branch7x7dbl_4", c7, c7, (7, 1), 1, "SAME"),
            ("branch7x7dbl_5", c7, 192, (1, 7), 1, "SAME"),
            ("branch_pool", cin, 192, (1, 1), 1, "VALID")])

    def forward(self, x):
        return torch.cat([
            self.chain(x, "branch1x1"),
            self.chain(x, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
            self.chain(x, "branch7x7dbl_1", "branch7x7dbl_2",
                       "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"),
            self.chain(_avgpool3(x), "branch_pool")], -1)


class InceptionD(_Branches):
    def __init__(self, cin: int):
        super().__init__([
            ("branch3x3_1", cin, 192, (1, 1), 1, "VALID"),
            ("branch3x3_2", 192, 320, (3, 3), 2, "VALID"),
            ("branch7x7x3_1", cin, 192, (1, 1), 1, "VALID"),
            ("branch7x7x3_2", 192, 192, (1, 7), 1, "SAME"),
            ("branch7x7x3_3", 192, 192, (7, 1), 1, "SAME"),
            ("branch7x7x3_4", 192, 192, (3, 3), 2, "VALID")])

    def forward(self, x):
        return torch.cat([
            self.chain(x, "branch3x3_1", "branch3x3_2"),
            self.chain(x, "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                       "branch7x7x3_4"),
            _maxpool3s2(x)], -1)


class InceptionE(_Branches):
    def __init__(self, cin: int):
        super().__init__([
            ("branch1x1", cin, 320, (1, 1), 1, "VALID"),
            ("branch3x3_1", cin, 384, (1, 1), 1, "VALID"),
            ("branch3x3_2a", 384, 384, (1, 3), 1, "SAME"),
            ("branch3x3_2b", 384, 384, (3, 1), 1, "SAME"),
            ("branch3x3dbl_1", cin, 448, (1, 1), 1, "VALID"),
            ("branch3x3dbl_2", 448, 384, (3, 3), 1, "SAME"),
            ("branch3x3dbl_3a", 384, 384, (1, 3), 1, "SAME"),
            ("branch3x3dbl_3b", 384, 384, (3, 1), 1, "SAME"),
            ("branch_pool", cin, 192, (1, 1), 1, "VALID")])

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        bd = self.chain(x, "branch3x3dbl_1", "branch3x3dbl_2")
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.chain(_avgpool3(x), "branch_pool")], -1)


class InceptionV3(nn.Module):
    """forward(x (N, H, W, 3)) -> (logits (N, 1000), pool3 (N, 2048))."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, (3, 3), 2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv(32, 64, (3, 3), padding="SAME")
        self.Conv2d_3b_1x1 = BasicConv(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = Dense(2048, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool3 = x.mean(dim=(1, 2))  # (N, 2048)
        return self.fc(pool3), pool3


def load_inception_params(path: str = DEFAULT_WEIGHTS):
    """The asset's flax tree {'params', 'batch_stats'} of numpy arrays, or
    None when there is no asset."""
    if not os.path.exists(path):
        return None
    return read_asset(path)


def inception_v3(params=None, device=None) -> Tuple[InceptionV3, bool]:
    """An InceptionV3 holding `params` (the asset's tree) or seeded random
    weights, on `device` (None: the CUDA card, which raises without one)
    -> (model, random_init)."""
    return load_variables(InceptionV3(), params,
                          eval_device(device, "InceptionV3"))


class InceptionScore:
    """Accumulating IS (reference evaluation/inception.py:8-49): collect
    softmax predictions over generated frames, then split-KL.

    `params`: the asset's tree (load_inception_params) or None for seeded
    random weights (`random_init`); `device`: None means the CUDA card,
    which raises without one. The frames are taken to fp32 before the
    resize (the network computes in fp32, as the JAX module does)."""

    def __init__(self, params=None, resize: bool = True, batch_size: int = 16,
                 device=None):
        self.model, self.random_init = inception_v3(params, device)
        self.device = next(self.model.parameters()).device
        self.resize = resize
        self.batch_size = batch_size
        self._probs = []

    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        if self.resize:
            x = resize_bilinear(x, (299, 299))
        logits, _ = self.model(x)
        return torch.softmax(logits, dim=-1)

    def clean(self):
        self._probs = []

    def __call__(self, imgs):
        """imgs: (N, H, W, 3), ImageNet-normalized or [-1,1]; an array or
        a tensor."""
        x = torch.as_tensor(imgs).to(self.device, torch.float32)
        with torch.no_grad():
            self._probs.append(self._fwd(x).cpu().numpy())

    def compute_score(self, splits: int = 5):
        if not self._probs:
            return 0.0, 0.0
        probs = np.concatenate(self._probs, axis=0)
        return inception_score_from_probs(probs, splits=splits)
