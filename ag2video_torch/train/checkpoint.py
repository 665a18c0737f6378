"""Checkpoints of the port's training state (port of
ag2video_tpu/train/checkpoint.py, in the port's own format).

The reference saves `itr_<t>.pt` with the models, every optimizer state
and the counters (scripts/train.py:528-543), and `run_args.json` describes
the run (train.py:352; reloaded by test.py:173-179). The JAX package
writes orbax directories, which the card machine cannot read; here
`<output_dir>/itr_<t>/` holds one `torch.save` (`train_state.pt`) of

    step, epoch, skipped_nan                        ints
    model, disc, vgg                                state dicts (vgg: None
                                                    without the VGG loss)
    opt_graph, opt_gen, opt_d                       {"state": the Adam's
                                                    state dict (with bf16
                                                    params, its fp32 masters
                                                    under "master"), "count":
                                                    its ScheduledAdam.count}

read back with `torch.load(weights_only=True)`. A LIGHT checkpoint holds
LIGHT_FIELDS only (no optimizer states) and has an `itr_<t>.light` marker
beside it; resuming from it restores the weights and counters and starts
the three Adams afresh (moments and schedule count at 0), as the JAX light
resume re-initialises the optax states; with bf16 params each master then
starts from the restored weights.

`save_checkpoint(block=False)` copies every tensor to host memory before it
returns and leaves only the disk write to a background thread: torch's Adam
updates parameters and moments in place, so a write that read the live
tensors would record a state the next step has half changed.
`wait_for_saves()` blocks until every scheduled write is on disk;
`restore_checkpoint` calls it first, and the training loop calls it before
it returns. Each save's host fetch and write times are appended to
`SAVE_TIMES`.
"""

from __future__ import annotations

import concurrent.futures
import glob
import json
import logging
import os
import re
import time
from typing import Any, Dict, List, Optional

import torch

from ag2video_torch.config import Config
from ag2video_torch.parallel.mesh import process_index

log = logging.getLogger(__name__)

STATE_FILE = "train_state.pt"
OPTIMIZERS = ("opt_graph", "opt_gen", "opt_d")
# Fields of a LIGHT checkpoint: everything inference and a weights-keeping
# resume need, i.e. the training state minus the three optimizer states.
LIGHT_FIELDS = ("step", "epoch", "model", "disc", "vgg", "skipped_nan")

# One background writer: saves are written in the order they were made.
_writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
_pending: List[concurrent.futures.Future] = []
# {"path", "light", "block", "fetch_s", "write_s", "bytes"} per save; the
# writer fills "write_s" and "bytes" of an async save when the file is on
# disk.
SAVE_TIMES: List[Dict[str, Any]] = []


def checkpoint_path(output_dir: str, t: int) -> str:
    return os.path.join(os.path.abspath(output_dir), f"itr_{t}")


def _light_marker(path: str) -> str:
    return os.path.abspath(path) + ".light"


def is_light_checkpoint(path: str) -> bool:
    return os.path.exists(_light_marker(path))


def is_port_checkpoint(path: str) -> bool:
    """An `itr_<t>/` directory written by this module (not an orbax one)."""
    return os.path.isfile(os.path.join(path, STATE_FILE))


def wait_for_saves() -> None:
    """Block until every scheduled async save is on disk (and re-raise a
    failed write)."""
    while _pending:
        _pending.pop(0).result()


def _host(obj: Any) -> Any:
    """A copy of `obj` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def state_to_host(state, light: bool = False) -> Dict[str, Any]:
    """The training state as a dict of host copies (see the module
    docstring); LIGHT_FIELDS only when `light`."""
    out = {"step": int(state.step), "epoch": int(state.epoch),
           "skipped_nan": int(state.skipped_nan),
           "model": _host(state.model.state_dict()),
           "disc": _host(state.disc.state_dict()),
           "vgg": None if state.vgg is None else _host(state.vgg.state_dict())}
    if not light:
        for name in OPTIMIZERS:
            opt = getattr(state, name)
            out[name] = {"state": _host(opt.state_dict()), "count": opt.count}
    return out


def _write(path: str, host_state: Dict[str, Any], record: Dict[str, Any]
           ) -> None:
    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(host_state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    record["write_s"] = time.perf_counter() - t0
    record["bytes"] = os.path.getsize(os.path.join(path, STATE_FILE))


def save_checkpoint(output_dir: str, t: int, epoch: int, state,
                    cfg: Config, vocab: Dict[str, Any],
                    block: bool = True, light: bool = False) -> str:
    """Save the training state at itr_<t> (with `run_args.json` and
    `counters.json` beside it; `epoch` goes to counters.json only, as in
    the JAX package: the state keeps its own). block=False returns once the host copy is
    made and leaves the write to the background writer. light=True saves
    LIGHT_FIELDS only and writes the `itr_<t>.light` marker.

    Under torch.distributed, only rank 0 writes (every rank holds the same
    replicated state, and concurrent writers into one directory race);
    the other ranks return the path it writes, as the JAX package's
    non-zero processes do."""
    if process_index() != 0:
        return checkpoint_path(output_dir, t)
    os.makedirs(output_dir, exist_ok=True)
    cfg.save_run_args(output_dir, vocab)
    path = checkpoint_path(output_dir, t)
    marker = _light_marker(path)
    t0 = time.perf_counter()
    host_state = state_to_host(state, light)
    record = {"path": path, "light": light, "block": block,
              "fetch_s": time.perf_counter() - t0, "write_s": None,
              "bytes": None}
    SAVE_TIMES.append(record)
    if light:
        with open(marker, "w") as f:
            json.dump({"fields": list(LIGHT_FIELDS)}, f)
    elif os.path.exists(marker):  # a full save over an old light one
        os.remove(marker)
    t0 = time.perf_counter()
    if block:
        wait_for_saves()
        _write(path, host_state, record)
        verb = "saved"
    else:
        _pending.append(_writer.submit(_write, path, host_state, record))
        verb = "scheduled async save of"
    with open(os.path.join(output_dir, "counters.json"), "w") as f:
        json.dump({"t": t, "epoch": epoch}, f)
    log.info("%s %s checkpoint %s (host fetch %.2fs, write phase %.2fs)",
             verb, "light" if light else "full", path, record["fetch_s"],
             time.perf_counter() - t0)
    return path


def latest_checkpoint(output_dir: str,
                      full_only: bool = False) -> Optional[str]:
    """Newest itr_<t> directory of this format; full_only=True skips light
    checkpoints (for a resume that must keep the optimizer states)."""
    best, best_t = None, -1
    for p in glob.glob(os.path.join(os.path.abspath(output_dir), "itr_*")):
        m = re.match(r".*itr_(\d+)$", p)
        if m and int(m.group(1)) > best_t and is_port_checkpoint(p):
            if full_only and is_light_checkpoint(p):
                continue
            best, best_t = p, int(m.group(1))
    return best


def resolve(path: str) -> str:
    """`path` itself if it names an itr_<t> directory, else the newest
    checkpoint under it."""
    if os.path.isdir(path) and not re.match(r".*itr_\d+$", path.rstrip("/")):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no itr_* checkpoints under {path}")
        return found
    return os.path.abspath(path)


def load_state_file(path: str) -> Dict[str, Any]:
    """The dict saved at checkpoint `path` (an itr_<t> directory), on the
    CPU."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, state, cfg: Config,
                       for_inference: bool = False):
    """Restore checkpoint `path` (an itr_<t> directory, or a run directory:
    its newest) into `state` in place, strictly; returns `state`.

    for_inference=True restores the models and `step` / `epoch` only. A
    LIGHT checkpoint restores LIGHT_FIELDS and re-initialises the three
    Adams from the restored weights (train.state.reset_optimizers)."""
    from ag2video_torch.train.state import reset_optimizers

    wait_for_saves()  # an async save of this very path may be in flight
    path = resolve(path)
    light = is_light_checkpoint(path)
    data = load_state_file(path)
    if (data["vgg"] is None) != (state.vgg is None):
        raise KeyError(f"{path}: VGG weights saved: {data['vgg'] is not None};"
                       f" VGG in the target: {state.vgg is not None}")
    state.model.load_state_dict(data["model"], strict=True)
    state.disc.load_state_dict(data["disc"], strict=True)
    if state.vgg is not None:
        state.vgg.load_state_dict(data["vgg"], strict=True)
    state.step, state.epoch = data["step"], data["epoch"]
    if for_inference:
        log.info("restored checkpoint %s for inference", path)
        return state
    state.skipped_nan = data["skipped_nan"]
    if light:
        reset_optimizers(state, cfg)
        log.warning(
            "resuming from LIGHT checkpoint %s: model weights + counters "
            "restored; optimizer states re-initialized from the restored "
            "weights (Adam moments and schedule count reset — see "
            "Config.full_checkpoint_every_n)", path)
    else:
        for name in OPTIMIZERS:
            opt = getattr(state, name)
            opt.load_state_dict(data[name]["state"])
            opt.count = data[name]["count"]
    log.info("restored checkpoint %s", path)
    return state
