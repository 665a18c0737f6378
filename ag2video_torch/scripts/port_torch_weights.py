"""Port pretrained torch weights into the local .npz assets (a copy of the
JAX package's scripts/port_torch_weights.py, held to it by
tests/test_torch_copies.py; it writes the same bytes, so one asset serves
both packages).

Consumes RAW state-dict files (``torch.load``-able .pth/.pt, or .npz of
numpy arrays) — no torchvision needed:

    python -m ag2video_torch.scripts.port_torch_weights --net vgg19      --state_dict vgg19-dcbb9e9d.pth          --out assets/vgg19.npz
    python -m ag2video_torch.scripts.port_torch_weights --net inception  --state_dict inception_v3_google.pth     --out assets/inception_v3.npz
    python -m ag2video_torch.scripts.port_torch_weights --net lpips_alex --state_dict alexnet-owt.pth \
        [--lpips_state_dict lpips_alex_lins.pth]                                                                  --out assets/lpips_alex.npz
    python -m ag2video_torch.scripts.port_torch_weights --net tsm        --state_dict TSM_kinetics_RGB_resnet50.pth --out assets/tsm.npz
    python -m ag2video_torch.scripts.port_torch_weights --net resnext3d  --state_dict resnext-101-kinetics.pth    --out assets/resnext3d.npz

With ``--from_torchvision`` (machines that have torchvision) the
vgg19/inception/lpips_alex state dicts are pulled from the model zoo
instead of a file; without torchvision that fails with its ImportError.

Reference weight sources: torchvision VGG19
(reference models/spade_models/networks/architecture.py:96), torchvision
InceptionV3 (reference evaluation/inception.py:8-20), LPIPS alex-lin
(reference evaluation/PerceptualSimilarity/models/dist_model.py), and the
Kinetics TSM/ResNeXt-101 checkpoints the reference downloads from Google
Drive at runtime (reference evaluation/video/inception.py:36-44).

2D kernels are transposed OIHW -> HWIO and 3D kernels OITHW -> THWIO for
flax. In a zero-egress environment this script is the documented path for
shipping the assets; the eval stack runs (flagged) with random backbones
when they're absent.
"""

from __future__ import annotations

import argparse
import pickle
import re
from typing import Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


# ------------------------------------------------------------- loading
def load_state_dict(path: str) -> StateDict:
    """Load a raw torch checkpoint (.pth/.pt) or .npz into numpy arrays.

    Accepts plain state dicts and the common {'state_dict': ...} wrapper
    (the Kinetics checkpoints use it)."""
    if path.endswith(".npz"):
        return {k: np.asarray(v) for k, v in np.load(path).items()}
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and not hasattr(
            next(iter(obj.values())), "shape"):
        for key in ("state_dict", "model", "net"):
            if key in obj:
                obj = obj[key]
                break
    return {k: np.asarray(v.detach().cpu().numpy())
            if hasattr(v, "detach") else np.asarray(v)
            for k, v in obj.items()}


def normalize_keys(sd: StateDict) -> StateDict:
    """Strip wrapper segments: DataParallel 'module.', TSN 'base_model.',
    and the TemporalShift '.net' conv wrapper (TSM checkpoints name the
    shifted convs 'layerX.Y.conv1.net.weight')."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^module\.", "", k)
        k = re.sub(r"^base_model\.", "", k)
        k = k.replace(".net.", ".")
        out[k] = v
    return out


def _hwio(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)          # OIHW -> HWIO


def _thwio(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 4, 1, 0)       # OITHW -> THWIO


def _save_tree(out_path: str, params: dict, batch_stats: dict):
    payload = {"params": params, "batch_stats": batch_stats}
    blob = np.frombuffer(pickle.dumps(payload), dtype=np.uint8)
    np.savez(out_path, params=blob)


def _seq_convs(sd: StateDict, prefix: str = "features.") -> list:
    """Conv (weight, bias) pairs from a torch nn.Sequential feature stack
    (VGG/AlexNet state dicts: 'features.<i>.weight'), in layer order."""
    idx = sorted(
        int(m.group(1))
        for k in sd
        if (m := re.fullmatch(rf"{re.escape(prefix)}(\d+)\.weight", k))
        and sd[k].ndim == 4)
    return [(sd[f"{prefix}{i}.weight"], sd[f"{prefix}{i}.bias"])
            for i in idx]


# ------------------------------------------------------------- porters
def port_vgg19(sd: StateDict, out_path: str):
    """VGG19 'features' convs -> models/vgg.py conv_{i}_kernel/bias."""
    convs = _seq_convs(normalize_keys(sd))
    if len(convs) != 16:
        raise ValueError(f"expected 16 VGG19 feature convs, got {len(convs)}")
    data = {}
    for i, (w, b) in enumerate(convs):
        data[f"conv_{i}_kernel"] = _hwio(w)
        data[f"conv_{i}_bias"] = b
    np.savez(out_path, **data)
    print(f"wrote {len(convs)} conv layers to {out_path}")


def port_lpips_alex(sd: StateDict, out_path: str,
                    lpips_sd: StateDict | None = None):
    """AlexNet 'features' convs + LPIPS linear calibration ->
    eval/lpips.py conv{i}_kernel/bias + lin{i}."""
    convs = _seq_convs(normalize_keys(sd))
    if len(convs) != 5:
        raise ValueError(f"expected 5 AlexNet convs, got {len(convs)}")
    data = {}
    for i, (w, b) in enumerate(convs):
        data[f"conv{i}_kernel"] = _hwio(w)
        data[f"conv{i}_bias"] = b
    if lpips_sd is not None:
        # richzhang lins: 'lin{i}.model.1.weight' (1, C, 1, 1), or bare
        # '{i}.weight' depending on packaging.
        lp = normalize_keys(lpips_sd)
        for i in range(5):
            for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                        f"{i}.weight"):
                if key in lp:
                    data[f"lin{i}"] = np.maximum(
                        lp[key].reshape(-1), 0).astype(np.float32)
                    break
            else:
                raise KeyError(f"no lin weight for slice {i} in lpips sd")
    else:
        print("no lpips lin state dict; writing uniform lin weights")
        for i, c in enumerate((64, 192, 384, 256, 256)):
            data[f"lin{i}"] = np.ones((c,), np.float32) / c
    np.savez(out_path, **data)
    print(f"wrote lpips alex weights to {out_path}")


_INCEPTION_MIXED = {
    "Mixed_5b": ["branch1x1", "branch5x5_1", "branch5x5_2",
                 "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3",
                 "branch_pool"],
    "Mixed_6a": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2",
                 "branch3x3dbl_3"],
    "Mixed_6b": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                 "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                 "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "Mixed_7a": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1",
                 "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"],
    "Mixed_7b": ["branch1x1", "branch3x3_1", "branch3x3_2a",
                 "branch3x3_2b", "branch3x3dbl_1", "branch3x3dbl_2",
                 "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"],
}
_INCEPTION_MIXED["Mixed_5c"] = _INCEPTION_MIXED["Mixed_5b"]
_INCEPTION_MIXED["Mixed_5d"] = _INCEPTION_MIXED["Mixed_5b"]
_INCEPTION_MIXED["Mixed_6c"] = _INCEPTION_MIXED["Mixed_6b"]
_INCEPTION_MIXED["Mixed_6d"] = _INCEPTION_MIXED["Mixed_6b"]
_INCEPTION_MIXED["Mixed_6e"] = _INCEPTION_MIXED["Mixed_6b"]
_INCEPTION_MIXED["Mixed_7c"] = _INCEPTION_MIXED["Mixed_7b"]
INCEPTION_STEM = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
                  "Conv2d_3b_1x1", "Conv2d_4a_3x3"]


def port_inception(sd: StateDict, out_path: str):
    """torchvision InceptionV3 state dict -> the flax tree of
    eval/inception.py (params + batch_stats, pickled into one npz)."""
    sd = normalize_keys(sd)

    def conv_block(prefix):
        return {
            "conv": {"kernel": _hwio(sd[f"{prefix}.conv.weight"])},
            "bn": {"scale": sd[f"{prefix}.bn.weight"],
                   "bias": sd[f"{prefix}.bn.bias"]},
        }, {
            "bn": {"mean": sd[f"{prefix}.bn.running_mean"],
                   "var": sd[f"{prefix}.bn.running_var"]},
        }

    params, stats = {}, {}
    for name in INCEPTION_STEM:
        params[name], stats[name] = conv_block(name)
    for block, branches in _INCEPTION_MIXED.items():
        params[block], stats[block] = {}, {}
        for b in branches:
            params[block][b], stats[block][b] = conv_block(f"{block}.{b}")
    params["fc"] = {"kernel": sd["fc.weight"].T, "bias": sd["fc.bias"]}

    _save_tree(out_path, params, stats)
    print(f"wrote inception weights to {out_path}")


def _port_resnet_body(sd: StateDict, layer_plan, kernel_tf):
    """Shared ResNet/ResNeXt body mapping: torch 'layer{s}.{b}.*' ->
    flax 'layer{s}_{b}' modules (eval/video_backbones.py naming)."""
    def bn(prefix):
        return ({"scale": sd[f"{prefix}.weight"],
                 "bias": sd[f"{prefix}.bias"]},
                {"mean": sd[f"{prefix}.running_mean"],
                 "var": sd[f"{prefix}.running_var"]})

    params, stats = {}, {}
    params["conv1"] = {"kernel": kernel_tf(sd["conv1.weight"])}
    params["bn1"], stats["bn1"] = bn("bn1")
    for s, blocks in enumerate(layer_plan, start=1):
        for b in range(blocks):
            t = f"layer{s}.{b}"
            name = f"layer{s}_{b}"
            p, st = {}, {}
            for j in (1, 2, 3):
                p[f"conv{j}"] = {"kernel": kernel_tf(sd[f"{t}.conv{j}.weight"])}
                p[f"bn{j}"], st[f"bn{j}"] = bn(f"{t}.bn{j}")
            if f"{t}.downsample.0.weight" in sd:
                p["downsample_conv"] = {
                    "kernel": kernel_tf(sd[f"{t}.downsample.0.weight"])}
                p["downsample_bn"], st["downsample_bn"] = bn(
                    f"{t}.downsample.1")
            params[name], stats[name] = p, st
    return params, stats


def port_tsm(sd: StateDict, out_path: str):
    """TSM ResNet-50 Kinetics checkpoint -> eval/video_backbones.py
    TSMResNet50 flax tree. TSM wraps shifted convs as '.net' and the whole
    backbone as 'module.base_model.'; normalize_keys strips both."""
    sd = normalize_keys(sd)
    params, stats = _port_resnet_body(sd, (3, 4, 6, 3), _hwio)
    _save_tree(out_path, params, stats)
    print(f"wrote TSM-ResNet50 weights to {out_path}")


def port_resnext3d(sd: StateDict, out_path: str):
    """Hara et al. ResNeXt-101 (3D, Kinetics) checkpoint ->
    eval/video_backbones.py ResNeXt3D101 flax tree."""
    sd = normalize_keys(sd)
    params, stats = _port_resnet_body(sd, (3, 4, 23, 3), _thwio)
    _save_tree(out_path, params, stats)
    print(f"wrote ResNeXt3D-101 weights to {out_path}")


# ----------------------------------------------------------------- CLI
def _torchvision_sd(net: str) -> StateDict:
    import torchvision

    model = {
        "vgg19": lambda: torchvision.models.vgg19(weights="IMAGENET1K_V1"),
        "lpips_alex": lambda: torchvision.models.alexnet(
            weights="IMAGENET1K_V1"),
        "inception": lambda: torchvision.models.inception_v3(
            weights="IMAGENET1K_V1", transform_input=False),
    }[net]()
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


PORTERS = {
    "vgg19": port_vgg19,
    "inception": port_inception,
    "lpips_alex": port_lpips_alex,
    "tsm": port_tsm,
    "resnext3d": port_resnext3d,
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--net", required=True, choices=sorted(PORTERS))
    p.add_argument("--out", required=True)
    p.add_argument("--state_dict", default=None,
                   help="raw torch checkpoint (.pth/.pt) or .npz")
    p.add_argument("--lpips_state_dict", default=None,
                   help="richzhang linear-calibration checkpoint "
                        "(lpips_alex only)")
    p.add_argument("--from_torchvision", action="store_true",
                   help="pull the state dict from torchvision instead of "
                        "--state_dict (vgg19/inception/lpips_alex)")
    args = p.parse_args(argv)

    if args.from_torchvision:
        sd = _torchvision_sd(args.net)
    elif args.state_dict:
        sd = load_state_dict(args.state_dict)
    else:
        p.error("provide --state_dict FILE or --from_torchvision")

    if args.net == "lpips_alex":
        lp = (load_state_dict(args.lpips_state_dict)
              if args.lpips_state_dict else None)
        port_lpips_alex(sd, args.out, lp)
    else:
        PORTERS[args.net](sd, args.out)


if __name__ == "__main__":
    main()
