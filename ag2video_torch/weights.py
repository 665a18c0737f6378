"""Weights: the bridge from the JAX package's variables, and a seeded init.

`from_flax(variables, model)` takes flax variables as a nested dict of
arrays with the `params`, `batch_stats` and `spectral` collections and loads
them strictly: every port parameter and buffer is filled and every JAX leaf
is used. The port's module tree mirrors the flax tree, so the mapping is by
name:

  params      .../kernel (HWIO)     -> .../weight (OIHW)
              .../kernel (in, out)  -> .../weight (out, in)   (Dense)
              .../embedding         -> .../weight             (Embed)
              .../scale, .../bias   -> .../weight, .../bias   (BatchNorm)
  batch_stats .../mean, .../var     -> .../running_mean, .../running_var
  spectral    X/SpectralNorm_0/conv/kernel/{u,sigma} -> X.spectral.{u,sigma}

Under flax's `nn.scan` the `step` / `frame_step` parameters carry no time
axis, so they map one to one. The SPADE blocks keep the three conditioning
convs of each norm separate and concatenate them at run time, exactly as
the JAX block does (spade.py:75-87).

`init_params(model, seed)` draws the port's own weights with flax's
initialisers by name (lecun-normal kernels, kaiming-normal in the graph
convs, zero biases, N(0, 1/features) embeddings, unit BN scale and
variance, N(0, 1) spectral `u`) from one `torch.Generator`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "embedding": "weight",
                 "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        # flax names spectral state 'conv/kernel/u': one key with slashes.
        key = prefix + tuple(str(k).split("/"))
        if isinstance(v, Mapping):
            yield from _flatten(v, key)
        else:
            yield key, v


def flax_to_state_dict(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables -> {port state_dict key: tensor} (no model needed)."""
    out: Dict[str, torch.Tensor] = {}
    for col, tree in variables.items():
        for path, leaf in _flatten(tree):
            arr = np.array(leaf, dtype=np.float32)
            *mod, name = path
            if col == "params":
                if name not in _PARAM_LEAVES:
                    raise KeyError(f"unknown param leaf {'/'.join(path)}")
                if name == "kernel" and arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                elif name == "kernel" and arr.ndim == 2:
                    arr = arr.T  # (in, out) -> (out, in)
                key = mod + [_PARAM_LEAVES[name]]
            elif col == "batch_stats":
                if name not in _STAT_LEAVES:
                    raise KeyError(
                        f"unknown batch_stats leaf {'/'.join(path)}")
                key = mod + [_STAT_LEAVES[name]]
            elif col == "spectral":
                cut = next((i for i, p in enumerate(mod)
                            if p.startswith("SpectralNorm")), None)
                if cut is None or name not in ("u", "sigma") or \
                        mod[cut + 1:] != ["conv", "kernel"]:
                    raise KeyError(f"unknown spectral leaf {'/'.join(path)}")
                key = mod[:cut] + ["spectral", name]
            else:
                raise KeyError(f"unknown variable collection {col!r}")
            out[".".join(key)] = torch.from_numpy(np.array(arr, order="C"))
    return out


def from_flax(variables: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Load flax variables into `model` strictly; returns the model."""
    converted = flax_to_state_dict(variables)
    state = model.state_dict()
    unused = sorted(set(converted) - set(state))
    missing = sorted(set(state) - set(converted))
    if unused or missing:
        raise KeyError(f"flax -> port mismatch: JAX leaves with no port "
                       f"tensor {unused[:8]}; port tensors with no JAX leaf "
                       f"{missing[:8]}")
    for k, v in converted.items():
        if tuple(v.shape) != tuple(state[k].shape):
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} vs port "
                             f"{tuple(state[k].shape)}")
    model.load_state_dict(converted, strict=True)
    return model


def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init with flax's initialisers by name (see module docstring)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        init = getattr(m, "init_", None)
        if init is not None:
            init(g)
    return model
