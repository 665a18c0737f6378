"""Fabricate seeded pretrained-layout state dicts for the evaluation
networks, and turn them into assets with the port's weight-port CLI.

    python3 torch_tools/eval_assets.py <dir> [--seed 0]

writes `<dir>/{vgg19,inception_v3,lpips_alex,tsm,resnext3d}.npz` through
`ag2video_torch.scripts.port_torch_weights.main`, from state dicts in the
layouts that CLI reads: torchvision's VGG19 (`features.<i>.*`), InceptionV3
(`Mixed_5b.branch1x1.conv.weight`, `.bn.running_mean`, `fc.*`) and AlexNet
with richzhang's LPIPS `lin{i}.model.1.weight`, and the Kinetics TSM
(`module.base_model.layer1.0.conv1.net.weight`, the wrappers the CLI
strips) and ResNeXt-101 (`module.layer1.0.downsample.0.weight`, OITHW)
checkpoints. The shapes come from the port's own modules, so every key
the CLI reads is there. Values are seeded: kernels N(0, 1/fan_in), biases
and BN shifts and means N(0, 0.01), BN scales 1 + N(0, 0.01), running
variances U(0.5, 1.5). No pretrained weights are involved: the networks
then compute real convolutions on weights with no meaning.
`chip_smoke.py` phase 13 and tests/test_torch_eval_stack.py use it.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from typing import Dict, Optional, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

StateDict = Dict[str, np.ndarray]

NETS = ("vgg19", "inception", "lpips_alex", "tsm", "resnext3d")
ASSET_NAMES = {"vgg19": "vgg19.npz", "inception": "inception_v3.npz",
               "lpips_alex": "lpips_alex.npz", "tsm": "tsm.npz",
               "resnext3d": "resnext3d.npz"}
# torchvision's feature indices of the convs (ReLU / MaxPool between).
VGG19_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)
VGG19_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512,
                512, 512, 512, 512)
ALEX_CONV_IDX = (0, 3, 6, 8, 10)


def _value(key: str, shape, rng: np.random.Generator) -> np.ndarray:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    if leaf == "weight" and len(shape) >= 2:
        v *= np.float32(1.0 / np.sqrt(np.prod(shape[1:])))
    elif leaf == "weight":        # a BN scale
        v = 1.0 + np.float32(0.1) * v
    else:                         # biases, BN shifts, running means
        v *= np.float32(0.1)
    return v


def pretrained_key(net: str, key: str) -> str:
    """The pretrained checkpoint's key of the port module's state-dict key
    `key`: InceptionV3's are torchvision's own; AlexNet's `conv{i}` is
    `features.<i>`; TSM / ResNeXt's `layer1_0.downsample_conv.weight` is
    `layer1.0.downsample.0.weight` (TSM: its shifted conv1 wrapped as
    `.net`, under `module.base_model.`; ResNeXt: under `module.`)."""
    if net == "lpips_alex":
        return re.sub(r"conv(\d)\.", lambda m: "features.%d." %
                      ALEX_CONV_IDX[int(m.group(1))], key)
    if net not in ("tsm", "resnext3d"):
        return key
    m = re.match(r"layer(\d+)_(\d+)\.(.*)", key)
    if m:
        s, b, rest = m.groups()
        rest = rest.replace("downsample_conv.", "downsample.0.")
        rest = rest.replace("downsample_bn.", "downsample.1.")
        if net == "tsm" and rest.startswith("conv1."):
            rest = "conv1.net." + rest[len("conv1."):]
        key = f"layer{s}.{b}.{rest}"
    return ("module.base_model." if net == "tsm" else "module.") + key


def port_module(net: str):
    """A fresh port module of `net` (not vgg19)."""
    from ag2video_torch.eval.inception import InceptionV3
    from ag2video_torch.eval.lpips import AlexNetFeatures
    from ag2video_torch.eval.video_backbones import (ResNeXt3D101,
                                                     TSMResNet50)

    return {"inception": InceptionV3, "lpips_alex": AlexNetFeatures,
            "tsm": TSMResNet50, "resnext3d": ResNeXt3D101}[net]()


def state_dicts(net: str, seed: int = 0
                ) -> Tuple[StateDict, Optional[StateDict]]:
    """(state dict, LPIPS lin state dict or None) of `net` in its
    pretrained layout, seeded."""
    rng = np.random.default_rng(seed)
    if net == "vgg19":
        shapes, cin = {}, 3
        for i, c in zip(VGG19_CONV_IDX, VGG19_WIDTHS):
            shapes[f"features.{i}.weight"] = (c, cin, 3, 3)
            shapes[f"features.{i}.bias"] = (c,)
            cin = c
    else:
        shapes = {pretrained_key(net, k): tuple(v.shape)
                  for k, v in port_module(net).state_dict().items()}
    sd = {k: _value(k, s, rng) for k, s in shapes.items()}
    lins = None
    if net == "lpips_alex":
        lins = {f"lin{i}.model.1.weight":
                rng.uniform(0.0, 0.2, (1, c, 1, 1)).astype(np.float32)
                for i, c in enumerate((64, 192, 384, 256, 256))}
    return sd, lins


def write_assets(out_dir: str, seed: int = 0, nets=NETS) -> Dict[str, str]:
    """Each net's state dict as an .npz under `out_dir`, then its asset
    through the port's weight-port CLI -> {net: asset path}."""
    from ag2video_torch.scripts.port_torch_weights import main as port_main

    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for net in nets:
        sd, lins = state_dicts(net, seed)
        sd_path = os.path.join(out_dir, f"{net}_state_dict.npz")
        np.savez(sd_path, **sd)
        argv = ["--net", net, "--state_dict", sd_path, "--out",
                os.path.join(out_dir, ASSET_NAMES[net])]
        if lins is not None:
            lins_path = os.path.join(out_dir, f"{net}_lins.npz")
            np.savez(lins_path, **lins)
            argv += ["--lpips_state_dict", lins_path]
        port_main(argv)
        os.remove(sd_path)
        out[net] = argv[argv.index("--out") + 1]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    for net, path in write_assets(args.out_dir, args.seed).items():
        print(net, path)


if __name__ == "__main__":
    main()
