"""The generation driver: `inference.generate` calls of the program, closed
loop, on a ring of seeded batches.

The traffic file sets the shapes (batch, frames, object / triplet / action
caps, image size), the ring of distinct batches, the loop and the counts of
the traced run and of the check:

* `"loop": "throughput"`: calls back to back, no synchronise between them
  (offline rendering: the host enqueues the next call while the card runs
  the last); the window ends in `torch.cuda.synchronize()`. Reports
  `frames_per_s`, the generated frames B*(T-1) of every call over the
  window's seconds.
* `"loop": "latency"`: each call timed from the call to its
  `synchronize()` (one user waits for one clip); reports `clip_ms_p95`
  over every call of the window.

Correctness: once the window has closed, the outputs of `check_calls`
calls drawn from the seed (kept as the window produced them) are compared
with the plain fp32 reference (benchmark/reference) on the same inputs and
weights, against the cell's limits: the predicted boxes by the worst clip's
relative L2 error (`boxes_err`), and the generated frames by the worst
clip's relative L2 error over that of the plain reference computed in bf16
on the same clips (`frames_gap_x_bf16`). How far rounding moves a frame
depends on the seed's weights (4x from seed to seed), so the frames' gap is
read in units of the seed's own bf16 rounding.
"""

from __future__ import annotations

import math
import os
import random
import time
from typing import Any, Dict, List, Optional

import torch

from benchmark import flops, inputs, weights
from benchmark.reference.generation import (APPEARANCE_DIM,
                                            AG2VideoReference, param_kinds)
from benchmark.stats import percentile

CHECKS = ("frames_gap_x_bf16", "boxes_err")


def vocab_sizes(vocab: Dict[str, Any]) -> Dict[str, Any]:
    """The sizes of a program vocabulary, as a configuration states them."""
    return {"attributes": [max(t.values()) + 1
                           for t in vocab["attributes"].values()],
            "attribute_names": list(vocab["attributes"]),
            "predicates": len(vocab["pred_idx_to_name"]),
            "pred_padding": vocab["pred_name_to_idx"]["__padding__"],
            "actions": len(vocab["action_idx_to_name"]),
            "action_padding": vocab["action_name_to_idx"]["__padding__"]}


def port_config(config: Dict[str, Any], traffic: Dict[str, Any]):
    """The program's Config and vocabulary for this configuration and
    traffic."""
    from ag2video_torch import Config, get_vocab

    vocab = get_vocab(config["dataset"])
    if vocab_sizes(vocab) != config["vocab"]:
        raise ValueError(f"the program's {config['dataset']} vocabulary "
                         f"{vocab_sizes(vocab)} is not the configuration's")
    m = dict(config["model"])
    m["image_size"] = tuple(m["image_size"])
    if tuple(traffic["image_size"]) != m["image_size"]:
        raise ValueError("the traffic's image size is not the config's")
    cfg = Config(dataset=config["dataset"], frames_per_action=traffic["frames"],
                 max_objects=traffic["max_objects"],
                 max_triplets=traffic["max_triplets"],
                 max_actions=traffic["max_actions"], **m).derive(vocab)
    return cfg, vocab


def reference_spec(config):
    """(shape, kind) of every weight, from the reference built on meta."""
    with torch.device("meta"):
        ref = AG2VideoReference(config)
    return weights.spec_of(ref, param_kinds(ref))


def clip_errors(pred_imgs, pred_boxes, ref_imgs, ref_boxes, ncond: int):
    """Per clip: relative L2 error of the generated frames and of the boxes
    (a NaN or inf output reads inf)."""
    def rel(a, r):
        a, r = a.double().flatten(1), r.double().flatten(1)
        e = (a - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)
        return torch.where(torch.isfinite(e), e, torch.full_like(e, math.inf))
    return (rel(pred_imgs[:, ncond:], ref_imgs[:, ncond:]).tolist(),
            rel(pred_boxes, ref_boxes).tolist())


def check_outputs(config, traffic, seed, ring, kept, device,
                  control: Optional[str] = None):
    """Per-clip relative L2 errors against the reference in fp32 (TF32
    off), in blocks of `ref_block` clips: {"program", "bf16" (the
    reference computed in bf16), and with `control` (a precision of
    benchmark/reference) "control"}, each {"frames": [...], "boxes":
    [...]}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = AG2VideoReference(config).to(device)
    ref.load_state_dict(weights.make_state(reference_spec(config), seed,
                                           device))
    ncond = config["model"]["n_frames_G"] - 1
    sides = ["program", "bf16"] + ([] if control is None else ["control"])
    errs = {k: {"frames": [], "boxes": []} for k in sides}
    blk = traffic["ref_block"]

    def add(acc, imgs, boxes, ri, rb):
        fe, be = clip_errors(imgs.float(), boxes.float(), ri, rb, ncond)
        acc["frames"] += fe
        acc["boxes"] += be

    # Without cuDNN: its heuristics pick FFT convs for fp32 without TF32
    # (~10x slower at these shapes); the native convs are im2col + GEMM.
    with torch.backends.cudnn.flags(enabled=False):
        for slot, imgs, boxes in kept:
            for lo in range(0, imgs.shape[0], blk):
                t = {k: torch.as_tensor(v[lo:lo + blk]).to(device)
                     for k, v in ring[slot].items()}
                args = (t["imgs"].float(), t["objs"], t["triplets"],
                        t["actions"].float(), t["boxes"].float())
                with torch.no_grad():
                    ri, rb = ref(*args)
                    add(errs["program"], imgs[lo:lo + blk],
                        boxes[lo:lo + blk], ri, rb)
                    for side, prec in (("bf16", "bfloat16"),
                                       ("control", control)):
                        if side in errs:
                            ref.prec = prec
                            add(errs[side], *ref(*args), ri, rb)
                            ref.prec = None
    del ref
    return errs


def worst(errs: Dict[str, Dict[str, List[float]]],
          side: str = "program") -> Dict[str, float]:
    """Each number compared, of `side`'s outputs: the worst clip's boxes
    error, and the worst clip's frames error over the bf16 reference's."""
    return {"frames_gap_x_bf16": max(errs[side]["frames"])
            / max(max(errs["bf16"]["frames"]), 1e-30),
            "boxes_err": max(errs[side]["boxes"])}


class HostEvent:
    """A host-clock stand-in for a CUDA event, for CPU tests."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """CUDA events in forward hooks on the program's named submodules: the
    rollouts (from `acts_to_boxes`' start to `acts_to_objs`' end), each
    frame step and each SPADE generator call. A module the program no
    longer has records nothing."""

    def __init__(self, model, on_card: bool):
        self.event = (lambda: torch.cuda.Event(enable_timing=True)) \
            if on_card else HostEvent
        self.sync = torch.cuda.synchronize if on_card else (lambda: None)
        self.marks: Dict[str, List] = {"rollout": [], "frame": [],
                                       "spade": []}
        self.handles = []
        first = getattr(model, "acts_to_boxes", None)
        last = getattr(model, "acts_to_objs", None) or first
        gen = getattr(model, "layout_to_video", None)
        step = getattr(gen, "frame_step", None)
        spade = getattr(step, "netG", None)
        self.missing = [n for n, m in (
            ("acts_to_boxes", first), ("layout_to_video.frame_step", step),
            ("layout_to_video.frame_step.netG", spade)) if m is None]
        if first is not None and last is not None:
            self._hook(first, last, "rollout")
        if step is not None:
            self._hook(step, step, "frame")
        if spade is not None:
            self._hook(spade, spade, "spade")

    def _hook(self, start_mod, end_mod, key):
        open_ = []

        def pre(*_):
            e = self.event()
            e.record()
            open_.append(e)

        def post(*_):
            e = self.event()
            e.record()
            self.marks[key].append((open_.pop(), e))

        self.handles.append(start_mod.register_forward_pre_hook(pre))
        self.handles.append(end_mod.register_forward_hook(post))

    def close(self) -> Dict[str, List[float]]:
        """Remove the hooks; ms of every span (after a synchronise)."""
        for h in self.handles:
            h.remove()
        self.sync()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.marks.items()}


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", fault=None) -> Dict[str, Any]:
    """One run of a generation cell; see the module docstring. `fault`, a
    test's hook, gets the program's model and may break it."""
    from ag2video_torch.inference import generate
    from ag2video_torch.models import AG2VideoModel

    config, traffic = cell["config"], cell["traffic"]
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    marks = [("imports", time.monotonic())]
    cfg, vocab = port_config(config, traffic)
    model = AG2VideoModel(cfg, vocab, device=device)
    sync()
    marks.append(("the program's model", time.monotonic()))
    model.load_state_dict(weights.make_state(reference_spec(config), seed,
                                             device))
    if fault is not None:
        fault(model)
    ring = inputs.make_ring(config["vocab"], traffic, seed)
    sync()
    marks.append(("seeded weights and inputs", time.monotonic()))
    K = len(ring)
    B, T = traffic["batch"], traffic["frames"]
    ncond = config["model"]["n_frames_G"] - 1
    latency = traffic["loop"] == "latency"
    for i in range(traffic["warmup"]):
        generate(model, ring[i % K])
    sync()
    w0 = time.perf_counter()
    generate(model, ring[0])
    sync()
    est_call_s = time.perf_counter() - w0
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    setup_s = time.monotonic() - t_start
    marks.append(("warm-up", t_start + setup_s))

    # The calls whose outputs are checked: drawn from the seed among those
    # the window is expected to reach (the last call stands in for any it
    # does not).
    rnd = random.Random(int(seed))
    reach = max(traffic["check_calls"], int(0.8 * seconds / est_call_s))
    want = set(rnd.sample(range(reach), traffic["check_calls"]))
    kept: Dict[int, tuple] = {}

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    host_s: List[float] = []
    call_s: List[float] = []
    attempted = failed = 0
    last = None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        slot = attempted % K
        ts = time.perf_counter()
        attempted += 1
        try:
            imgs, boxes = generate(model, ring[slot])
        except RuntimeError:
            failed += 1
            imgs = boxes = None
        host_s.append(time.perf_counter() - ts)
        if latency:
            sync()
            call_s.append(time.perf_counter() - ts)
        if imgs is not None:
            last = (slot, imgs, boxes)
            if attempted - 1 in want:
                kept[attempted - 1] = last
        if time.perf_counter() >= deadline:
            break
    sync()
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    completed = attempted - failed

    e2e = {"frames_per_s": completed * B * (T - ncond) / window_s}
    if latency:
        e2e["clip_ms_p95"] = percentile(call_s, 95.0) * 1e3
    out: Dict[str, Any] = {
        "attempted": attempted, "failed": failed, "e2e": e2e,
        "setup_s": setup_s, "memory_peak_bytes": max(setup_peak, window_peak),
        "notes": [f"{attempted} calls in {window_s:.3f} s "
                  f"({'latency' if latency else 'throughput'} loop, B={B}, "
                  f"T={T})", power_limit() if on_card else "cpu",
                  "set-up s: " + ", ".join(
                      f"{name} {t - prev:.3f}" for prev, (name, t)
                      in zip([t_start] + [t for _, t in marks], marks))]}

    if trace:
        fl = flops.model_flops(AG2VideoReference, config,
                               {k: v for k, v in ring[0].items()})
        ctx: Dict[str, Any] = {
            "calls": completed, "window_s": window_s, "host_s": host_s,
            "flops_per_call": fl, "peak_bytes": window_peak}
        spans = Spans(model, on_card)
        if spans.missing:
            out["notes"].append("no module " + ", ".join(spans.missing)
                                + " in the program: its spans read nothing")
        for i in range(traffic["span_calls"]):
            generate(model, ring[i % K])
        ctx["spans"] = spans.close()
        if not cfg.factorized_frontend:
            n_attr = len(config["vocab"]["attributes"])
            D = (APPEARANCE_DIM // n_attr) * n_attr + \
                config["model"]["gconv_dim"]
            H, W = traffic["image_size"]
            ctx["raster_shape"] = (B * T, traffic["max_objects"], D, H, W)
        if on_card:
            from benchmark.trace import trace_calls
            ctx["slice"] = trace_calls(
                lambda: generate(model, ring[0]), traffic["trace_calls"],
                sync, os.environ.get("TMPDIR"))
        out["ctx"] = ctx

    # The program's state goes before the reference runs.
    kept_list = [kept.get(i) for i in sorted(want)]
    kept_list = [k if k is not None else last for k in kept_list]
    kept_list = [k for k in kept_list if k is not None]
    del model
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    if kept_list:
        errs = check_outputs(config, traffic, seed, ring, kept_list, device)
        checks = worst(errs)
        out["notes"].append(
            f"worst clip's frames error {max(errs['program']['frames'])!r}, "
            f"the bf16 reference's {max(errs['bf16']['frames'])!r}")
    else:
        checks = {k: math.inf for k in CHECKS}
    out["notes"].append(f"the reference took {time.perf_counter() - r0:.1f} s")
    out["checks"] = checks
    out["compared_clips"] = sum(k[1].shape[0] for k in kept_list)
    return out
