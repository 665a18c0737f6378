"""Weights: the bridge from the JAX package's variables, and a seeded init.

`from_flax(variables, model)` takes flax variables as a nested dict of
arrays with the `params`, `batch_stats` and `spectral` collections and loads
them strictly: every port parameter and buffer is filled and every JAX leaf
is used. The port's module tree mirrors the flax tree, so the mapping is by
name:

  params      .../kernel (HWIO)     -> .../weight (OIHW)
              .../kernel (HWIO) of a ConvTranspose -> .../weight (I, O, kh,
                                    kw), flipped in kh and kw (torch's
                                    conv_transpose layout; flax does not
                                    flip, layers.conv_transpose2d_nhwc)
              .../kernel (THWIO)    -> .../weight (OITHW)     (3-D conv)
              .../kernel (in, out)  -> .../weight (out, in)   (Dense)
              .../embedding         -> .../weight             (Embed)
              .../scale, .../bias   -> .../weight, .../bias   (BatchNorm)
  batch_stats .../mean, .../var     -> .../running_mean, .../running_var
  spectral    X/SpectralNorm_0/conv/kernel/{u,sigma} -> X.spectral.{u,sigma}
              X/SpectralNorm_0/dense/kernel/{u,sigma} (SNDense) -> the same
              X/u (FactorizedNormConv's own)       -> X.u

Under flax's `nn.scan` the `step` / `frame_step` parameters carry no time
axis, so they map one to one. The SPADE blocks keep the three conditioning
convs of each norm separate and concatenate them at run time, exactly as
the JAX block does (spade.py:75-87).

A ConvTranspose kernel has the shape of a Conv kernel, so the mapping
takes the port keys of the ConvTranspose weights (`transposed_keys`,
found in the model by `from_flax` and `adam_from_optax`).

`to_flax(template, state_dict)` maps back: the port's tensors into a flax
tree of the template's structure, in flax's layouts.

`init_params(model, seed)` draws the port's own weights with flax's
initialisers by name (lecun-normal kernels, kaiming-normal in the graph
convs, zero biases, N(0, 1/features) embeddings, unit BN scale and
variance, N(0, 1) spectral `u`, N(0, 1/features) factorized `u`) from one
`torch.Generator`.

`load_flax_npz(path, model)` loads an exported run's weights, an .npz in
the layout of flax_npz.py (written by torch_tools/export_run_weights.py).
`read_asset(path)` reads an evaluation network's asset (written by
scripts/port_torch_weights.py, the JAX package's or the port's): the
pickled `{"params", "batch_stats"}` tree of numpy arrays in its `params`
entry, read with numpy and pickle alone; `from_flax` then loads it.

The same mapping loads the discriminator (`gcn_step/*` under its scan,
`fc_objs_vecs`, `discriminator_{i}/model{n}/...` and its `spectral`
collection) and the VGG (`conv_{i}`). `trainer_from_flax(state, trainer)`
carries a whole JAX TrainState into a Trainer, strictly: the model,
discriminator and VGG from params / model_state / d_params / d_state /
vgg_params; `step`, `epoch` and `skipped_nan`; and the three optax Adam
states. Each optax state's `mu` / `nu` (parameter trees, with MaskedNode
where `optax.masked` leaves a subtree to the other optimizer) become
`exp_avg` / `exp_avg_sq` of exactly the parameters in that Adam's
`param_groups`, and its `count` becomes torch's `step` and
`ScheduledAdam.count`, so a JAX run's state resumes training here. A bf16
TrainState (param_dtype='bfloat16') carries its `{"master", "inner"}`
optax states: the masters fill the Adams' fp32 masters.
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ag2video_torch.flax_npz import flatten_tree, read_flax_npz

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "embedding": "weight",
                 "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def transposed_keys(model: nn.Module) -> FrozenSet[str]:
    """The state_dict keys of `model`'s ConvTranspose weights."""
    from ag2video_torch.models.layers import ConvTranspose

    return frozenset(f"{n}.weight" if n else "weight"
                     for n, m in model.named_modules()
                     if isinstance(m, ConvTranspose))


# Kernel layouts: flax -> port, and back (to_flax).
_TO_PORT = {
    "transposed": lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1),
    4: lambda a: a.transpose(3, 2, 0, 1),        # HWIO -> OIHW
    5: lambda a: a.transpose(4, 3, 0, 1, 2),     # THWIO -> OITHW
    2: lambda a: a.T,                            # (in, out) -> (out, in)
}
_TO_FLAX = {
    "transposed": lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1],
    4: lambda a: a.transpose(2, 3, 1, 0),
    5: lambda a: a.transpose(2, 3, 4, 1, 0),
    2: lambda a: a.T,
}


def _layout(col: str, path, key: str, ndim: int,
            transposed: FrozenSet[str]):
    """The kernel layout (a key of _TO_PORT) of a flax leaf, or None."""
    if col != "params" or path[-1] != "kernel":
        return None
    if key in transposed:
        return "transposed"
    return ndim if ndim in _TO_PORT else None


def _port_key(col: str, path) -> str:
    """The port state_dict key of the flax leaf at `path` in `col`."""
    *mod, name = path
    if col == "params":
        if name not in _PARAM_LEAVES:
            raise KeyError(f"unknown param leaf {'/'.join(path)}")
        key = mod + [_PARAM_LEAVES[name]]
    elif col == "batch_stats":
        if name not in _STAT_LEAVES:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        key = mod + [_STAT_LEAVES[name]]
    elif col == "spectral":
        cut = next((i for i, p in enumerate(mod)
                    if p.startswith("SpectralNorm")), None)
        if cut is None and name == "u":
            key = mod + ["u"]  # factorized.spectral_normalize's u
        elif cut is None or name not in ("u", "sigma") or \
                mod[cut + 1:] not in (["conv", "kernel"], ["dense", "kernel"]):
            raise KeyError(f"unknown spectral leaf {'/'.join(path)}")
        else:
            key = mod[:cut] + ["spectral", name]
    else:
        raise KeyError(f"unknown variable collection {col!r}")
    return ".".join(key)


def flax_to_state_dict(
        variables: Mapping[str, Any],
        transposed: FrozenSet[str] = frozenset()
) -> Dict[str, torch.Tensor]:
    """Flax variables -> {port state_dict key: tensor}. `transposed`: the
    port keys whose kernels are ConvTranspose kernels (transposed_keys of
    the model); without them no model is needed."""
    out: Dict[str, torch.Tensor] = {}
    for col, tree in variables.items():
        for path, leaf in flatten_tree(tree):
            arr = np.array(leaf, dtype=np.float32)
            key = _port_key(col, path)
            layout = _layout(col, path, key, arr.ndim, transposed)
            if layout is not None:
                arr = _TO_PORT[layout](arr)
            out[key] = torch.from_numpy(np.array(arr, order="C"))
    return out


def to_flax(template: Mapping[str, Any], state: Mapping[str, torch.Tensor],
            transposed: FrozenSet[str] = frozenset()) -> Dict[str, Any]:
    """The inverse of flax_to_state_dict: `template`'s nested flax structure
    (collections at the top; its leaves are only placeholders) with each
    leaf taken from the port's `state` (a state_dict) as an fp32 numpy
    array in flax's layout."""
    def walk(col, node, path):
        out = {}
        for k, v in node.items():
            p = path + tuple(str(k).split("/"))
            if isinstance(v, Mapping):
                out[k] = walk(col, v, p)
                continue
            key = _port_key(col, p)
            t = state[key]
            layout = _layout(col, p, key, t.dim(), transposed)
            arr = t.detach().cpu().float().numpy()
            if layout is not None:
                arr = _TO_FLAX[layout](arr)
            out[k] = np.array(arr, order="C")
        return out

    return {col: walk(col, tree, ()) for col, tree in template.items()}


def load_flax_npz(path: str, model: nn.Module) -> nn.Module:
    """Load an .npz of flax variables (flax_npz.py) into `model` strictly."""
    return from_flax(read_flax_npz(path), model)


def read_asset(path: str) -> Optional[Dict[str, Any]]:
    """The flax tree pickled in an evaluation asset's `params` entry
    (scripts/port_torch_weights.py `_save_tree`), or None when the .npz has
    no such entry."""
    import pickle

    with np.load(path) as data:
        if "params" not in data:
            return None
        return pickle.loads(data["params"].tobytes())


def from_flax(variables: Mapping[str, Any], model: nn.Module) -> nn.Module:
    """Load flax variables into `model` strictly; returns the model."""
    converted = flax_to_state_dict(variables, transposed_keys(model))
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


def _field(node: Any, name: str) -> Any:
    if isinstance(node, Mapping):
        return node.get(name)
    return getattr(node, name, None) if hasattr(node, "_fields") else None


def adam_state(opt_state: Any) -> Any:
    """The one optax ScaleByAdamState (count, mu, nu) inside an optimizer
    state: nested namedtuples, or the mappings of
    flax.serialization.to_state_dict."""
    found = []

    def walk(node):
        if _field(node, "mu") is not None and _field(node, "nu") is not None:
            found.append(node)
        elif isinstance(node, Mapping):
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(opt_state)
    if len(found) != 1:
        raise KeyError(f"expected one Adam state (mu, nu) in the optimizer "
                       f"state, found {len(found)}")
    return found[0]


def _unmasked(tree: Any) -> Any:
    """`tree` without optax.masked's MaskedNode leaves (empty tuples, or
    empty mappings after to_state_dict)."""
    if isinstance(tree, Mapping):
        out = {k: _unmasked(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if not (isinstance(v, (tuple, Mapping)) and len(v) == 0)}
    return tree


def _master_tree(opt_state: Any) -> Any:
    """The `master` tree of a with_fp32_master state inside an optimizer
    state, or None."""
    found = []

    def walk(node):
        if isinstance(node, Mapping):
            if "master" in node and "inner" in node:
                found.append(node["master"])
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v)

    walk(opt_state)
    if len(found) > 1:
        raise KeyError(f"{len(found)} fp32 masters in one optimizer state")
    return found[0] if found else None


def adam_from_optax(opt_state: Any, opt: torch.optim.Optimizer,
                    module: nn.Module) -> None:
    """Fill `opt` (a ScheduledAdam over parameters of `module`) from an
    optax Adam state, strictly: every parameter of `opt` gets its moments
    and every unmasked leaf of the optax state is used. A with_fp32_master
    state (param_dtype='bfloat16') fills the Adam's fp32 masters from its
    `master` tree; its `inner` Adam gives the moments."""
    adam = adam_state(opt_state)
    count = int(np.asarray(_field(adam, "count")))
    tk = transposed_keys(module)
    mu = flax_to_state_dict({"params": _unmasked(_field(adam, "mu"))}, tk)
    nu = flax_to_state_dict({"params": _unmasked(_field(adam, "nu"))}, tk)
    master = _master_tree(opt_state)
    if (master is None) != (opt.live is None):
        raise KeyError(f"fp32 master in the optax state: "
                       f"{master is not None}; in the optimizer: "
                       f"{opt.live is not None}")
    if master is not None:
        master = flax_to_state_dict({"params": _unmasked(master)}, tk)
    names = {id(p): n for n, p in module.named_parameters()}
    params = [p for g in opt.param_groups for p in g["params"]]
    lives = opt.live_params()
    wanted = sorted(names[id(p)] for p in lives)
    if wanted != sorted(mu) or wanted != sorted(nu) or (
            master is not None and wanted != sorted(master)):
        raise KeyError(f"optax moments vs the optimizer's parameters: "
                       f"{sorted(set(mu) ^ set(wanted))[:8]}")
    opt.state.clear()
    for p, live in zip(params, lives):
        n = names[id(live)]
        if tuple(mu[n].shape) != tuple(p.shape):
            raise ValueError(f"{n}: optax moment shape {tuple(mu[n].shape)}"
                             f" vs parameter {tuple(p.shape)}")
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[n].to(p.device, p.dtype),
            "exp_avg_sq": nu[n].to(p.device, p.dtype)}
        if master is not None:
            with torch.no_grad():
                p.copy_(master[n])
    opt.count = count


def trainer_from_flax(state: Any, trainer) -> Any:
    """Load a JAX TrainState (or a mapping with its fields) into `trainer`
    (an initialised ag2video_torch.train.Trainer), strictly: weights,
    counters and the three Adam states; returns it."""
    get = (lambda k: state[k]) if isinstance(state, Mapping) \
        else (lambda k: getattr(state, k))
    st = trainer.state
    from_flax({"params": get("params"), **get("model_state")}, st.model)
    from_flax({"params": get("d_params"), **get("d_state")}, st.disc)
    vgg = get("vgg_params")
    if (vgg is None) != (st.vgg is None):
        raise KeyError(f"VGG params on the JAX side: {vgg is not None}; "
                       f"VGG in the trainer: {st.vgg is not None}")
    if vgg is not None:
        from_flax({"params": vgg}, st.vgg)
    adam_from_optax(get("opt_graph_state"), st.opt_graph, st.model)
    adam_from_optax(get("opt_gen_state"), st.opt_gen, st.model)
    adam_from_optax(get("opt_d_state"), st.opt_d, st.disc)
    st.step = int(np.asarray(get("step")))
    st.epoch = int(np.asarray(get("epoch")))
    st.skipped_nan = int(np.asarray(get("skipped_nan")))
    return trainer
