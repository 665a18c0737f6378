"""The training driver: `Trainer` iterations of the program, closed loop,
on a ring of seeded batches.

One iteration is what `Trainer.fit` runs for each step: `train_step` on a
batch of `batch` clips of `frames` frames (the G step, then the D step),
then `graph_step` on a batch of clips of 4 * frames_per_action_graph
frames (the rollout alone), each batch uploaded by the trainer's own
`_batch`. The traffic file sets the shapes, the ring of distinct batches,
the warm-up and the training keys (`train`, the program's Config names:
discriminator, losses, optimizers), which the configuration file does not
hold. Iterations run back to back; the window ends in
`torch.cuda.synchronize()`. Reports `train_samples_per_s`: the clips of
every iteration completed in the window (an iteration that the trainer's
NaN guard skipped counts as failed) over the window's seconds.

Correctness: set-up builds one trainer, loads the benchmark's seeded
weights into it, and drives it through the first `warmup` iterations from
the seed, on distinct batches, through the calls and the feed the window
times; the window goes on with that same trainer. The plain fp32
reference (benchmark/reference/training.py, TF32 and cuDNN off) follows
the first `check_steps` of them from the same weights and batches once
the window has closed and the program's state is freed. A gap of norms
is taken leaf by leaf as |program - reference| over the larger of the
reference's and its group's median leaf's. The numbers:

* `frames_gap_x_bf16`: the frames the first iteration's G step generates
  (its train forward from the seed's weights), the worst clip's relative
  L2 error against the reference's over the error of the reference's own
  forward in bf16 on the same clip: the G step's precision, read before
  Adam or the GAN's feedback can blur it;
* `loss_gap_first`: every loss term of the first iteration (the group:
  its terms; a term the program does not report reads 0), the worst;
* `grad_gap`: the first gradient each of the three Adams got, as the
  program's Adams hold it after one step (exp_avg / (1 - beta1)), by the
  gap of norms, the worst leaf;
* `grad_gap_median`: the same, the median leaf of the worst Adam;
* `update_gap_median`: each weight's change after the checked
  iterations by the gap of norms, the median leaf of the worst Adam,
  leaving out leaves whose reference first gradient is under a thousandth
  of its Adam's median leaf's (they move by round-off alone);
* `graph_grad_diff`: the rollout Adam's first gradient, ||program -
  reference|| / ||reference|| over all its leaves.

The later iterations' losses, the worst leaf's change and the generator's
whole-gradient difference are printed, not compared: the generator's
gradient at this configuration moves by a quarter or more between bf16
and fp32 arithmetic, in the program and in the plain reference alike, and
what follows from it swings from seed to seed. The worst leaf's change
after the checked iterations (as a rule the object GCN's box head) moves
by up to a sixth when the fp32 reference's weights move by a millionth,
and reads alike in the program and in the reference at one precision
(PERF.md gives the readings).

The notes also give what the host did in the window (the process's CPU
seconds, its threads, its context switches, the load and the host's
stolen CPU time), since the host sets this loop's pace.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import resource
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs, weights
from benchmark.drivers.generate import port_config, power_limit
from benchmark.reference import generation as gen
from benchmark.reference.training import GROUPS, TrainingReference

CHECKS = ("frames_gap_x_bf16", "loss_gap_first", "grad_gap",
          "grad_gap_median", "update_gap_median", "graph_grad_diff")
MOVED_BY_ROUNDOFF = 1e-3


def train_config(config, traffic):
    """The program's Config (its training keys from the traffic) and
    vocabulary."""
    cfg, vocab = port_config(config, traffic)
    return cfg.replace(batch_size=traffic["batch"], **traffic["train"]), \
        vocab


def graph_traffic(traffic):
    """The graph step's batches: clips of 4 * frames_per_action_graph
    frames. The graph step never reads pixels (the trainer sends a stub),
    so their frames are 1x1."""
    frames = 4 * traffic["train"]["frames_per_action_graph"]
    return dict(traffic, frames=frames, image_size=[1, 1])


def smooth_frames(rng, shape, cells: int) -> np.ndarray:
    """(B, T, H, W, 3) frames in (-1, 1): per frame and channel an N(0, 1)
    grid of cells x cells, bilinearly upsampled, through tanh. Smooth as
    rendered frames are: on N(0, 1) pixels the warp's gradient with
    respect to the flow jumps at every pixel boundary."""
    B, T, H, W, C = shape
    grid = rng.standard_normal((B * T, C, cells, cells), dtype=np.float32)
    up = F.interpolate(torch.from_numpy(grid), size=(H, W), mode="bilinear",
                       align_corners=False)
    return np.tanh(up.permute(0, 2, 3, 1).reshape(shape).numpy())


def make_rings(config, traffic, seed):
    """`ring` distinct (train batch, graph batch) pairs from `seed`; the
    train batches' frames smooth with `frame_cells`."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    gt = graph_traffic(traffic)
    rings = []
    for _ in range(traffic["ring"]):
        b = inputs.make_batch(config["vocab"], traffic, rng)
        if traffic.get("frame_cells"):
            b["imgs"] = smooth_frames(rng, b["imgs"].shape,
                                      traffic["frame_cells"])
        rings.append((b, inputs.make_batch(config["vocab"], gt, rng)))
    return rings


def reference(config, traffic, prec=None) -> TrainingReference:
    return TrainingReference(config, traffic["train"], prec)


def training_spec(config, traffic):
    """(shape, kind) of every weight of G, D and VGG, by the program's
    state-dict names, from the reference built on meta."""
    with torch.device("meta"):
        ref = reference(config, traffic)
    return weights.spec_of(ref, gen.param_kinds(ref))


def split_state(state: Dict[str, torch.Tensor]):
    """model.* / disc.* / vgg.* -> three state dicts."""
    out: Dict[str, Dict[str, torch.Tensor]] = {"model": {}, "disc": {},
                                               "vgg": {}}
    for k, v in state.items():
        head, rest = k.split(".", 1)
        out[head][rest] = v
    return out


def load_program(trainer, state) -> None:
    st, parts = trainer.state, split_state(state)
    st.model.load_state_dict(parts["model"])
    st.disc.load_state_dict(parts["disc"])
    if st.vgg is not None:
        st.vgg.load_state_dict(parts["vgg"])


def program_groups(trainer) -> Dict[str, Dict[str, torch.nn.Parameter]]:
    """Each Adam's weights by state-dict name (model.*, disc.*)."""
    st = trainer.state
    names = {id(p): "model." + n for n, p in st.model.named_parameters()}
    names.update({id(p): "disc." + n for n, p in st.disc.named_parameters()})
    opts = {"graph": st.opt_graph, "gen": st.opt_gen, "disc": st.opt_d}
    return {g: {names[id(p)]: p for p in opts[g].live_params()}
            for g in GROUPS}, opts


def first_gradients(trainer) -> Dict[str, Dict[str, Any]]:
    """The gradient each Adam got at its first update, leaf by leaf (None
    where it took none), from its state after that update: exp_avg = (1 -
    beta1) g; on the host."""
    groups, opts = program_groups(trainer)
    b1 = trainer.cfg.beta1
    out = {}
    for g in GROUPS:
        state = opts[g].state
        out[g] = {n: (state[p]["exp_avg"].detach().float().cpu() / (1 - b1)
                      if "exp_avg" in state.get(p, {}) else None)
                  for n, p in groups[g].items()}
    return out


def on_host(grads: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    return {g: {n: None if t is None else t.detach().float().cpu()
                for n, t in ws.items()} for g, ws in grads.items()}


def leaf_norms(tensors: Dict[str, Any]) -> Dict[str, float]:
    """The L2 norm of every leaf (0 for None), on the host."""
    return {n: 0.0 if t is None else float(t.detach().double().norm())
            for n, t in tensors.items()}


def change_norms(named: Dict[str, Dict[str, torch.Tensor]],
                 start: Dict[str, torch.Tensor]
                 ) -> Dict[str, Dict[str, float]]:
    """Per Adam, each weight's ||now - start||."""
    return {g: leaf_norms({n: p.detach() - start[n] for n, p in ws.items()})
            for g, ws in named.items()}


def losses_of(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def loss_gaps(prog, ref, i: int) -> Tuple[float, str]:
    """The worst loss term of iteration i: |program - reference| over the
    larger of the reference's term and the iteration's median term (a
    term the program does not report reads 0) -> (gap, term)."""
    lr = ref["losses"][i]
    lp = prog["losses"][i] if i < len(prog["losses"]) else {}
    med = float(np.median([abs(v) for v in lr.values()]))
    return max(((_gap(lp.get(k, 0.0), v, max(abs(v), med)), k)
                for k, v in lr.items()), default=(0.0, ""))


def _gap(got: float, want: float, den: float) -> float:
    """|got - want| / den; inf where that is not a finite number."""
    gap = abs(got - want) / den if den > 0 else \
        (0.0 if got == want else math.inf)
    return gap if math.isfinite(gap) else math.inf


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              skip=()) -> Dict[str, float]:
    """Each leaf's gap of norms, |got - want| over the larger of want and
    the median leaf's want (leaves in `skip` left out, a leaf missing from
    `got` read as 0)."""
    keep = [k for k in want if k not in skip]
    med = float(np.median([want[k] for k in keep])) if keep else 0.0
    return {k: _gap(got.get(k, 0.0), want[k], max(want[k], med))
            for k in keep}


def relative_difference(got: Dict[str, Any], ref: Dict[str, Any]) -> float:
    """||got - ref|| / ||ref|| of the whole gradient of one Adam (a leaf
    None on one side reads 0 there)."""
    num = den = 0.0
    for n, r in ref.items():
        p = got.get(n)
        if r is None and p is None:
            continue
        r = torch.zeros_like(p) if r is None else r.double()
        p = torch.zeros_like(r) if p is None else p.double()
        num += float((p - r).square().sum())
        den += float(r.square().sum())
    return _gap(math.sqrt(num), 0.0, math.sqrt(den))


def frames_gap(got: torch.Tensor, ref: Dict[str, Any]) -> float:
    """The worst clip's ||got - fp32|| / ||bf16 - fp32|| of the first
    iteration's generated frames (inf where the shapes differ)."""
    want, bf16 = ref["frames"].double(), ref["frames_bf16"].double()
    if got is None or got.shape != want.shape:
        return math.inf
    dims = tuple(range(1, want.dim()))
    num = (got.double() - want).square().sum(dims).sqrt()
    den = (bf16 - want).square().sum(dims).sqrt()
    return max(_gap(float(n), 0.0, float(d)) for n, d in zip(num, den))


def compare(prog, ref) -> Dict[str, Any]:
    """The program's readings `prog` against the reference's `ref` (each
    {"frames": the first iteration's generated frames, "losses": [per
    iteration {term: value}], "grads": {Adam: {leaf: tensor}}, "first":
    {Adam: {leaf: norm}}, "change": {Adam: {leaf: norm}}}, the
    reference's with "frames_bf16" too): the frames' gap, the worst loss
    term of each iteration, and per Adam the leaves' gradient and change
    gaps, the leaves left out of the change (reference gradient under
    MOVED_BY_ROUNDOFF of the median leaf's) and the whole gradient's
    relative difference."""
    out: Dict[str, Any] = {"frames": frames_gap(prog["frames"], ref),
                           "losses": [loss_gaps(prog, ref, i)
                                      for i in range(len(ref["losses"]))]}
    for g in GROUPS:
        fr = ref["first"][g]
        med = float(np.median(list(fr.values()))) if fr else 0.0
        skip = [k for k, v in fr.items() if v < MOVED_BY_ROUNDOFF * med]
        out[g] = {"grad": leaf_gaps(prog["first"][g], fr),
                  "update": leaf_gaps(prog["change"][g], ref["change"][g],
                                      skip),
                  "left_out": len(skip),
                  "diff": relative_difference(prog["grads"][g],
                                              ref["grads"][g])}
    return out


def numbers(c: Dict[str, Any]) -> Tuple[Dict[str, float], List[str]]:
    """The numbers compared (CHECKS), from `compare`'s result -> (numbers,
    where each is worst)."""
    def median(d):
        return float(np.median(list(d.values()))) if d else 0.0

    out, where = {}, {}
    out["frames_gap_x_bf16"], where["frames_gap_x_bf16"] = \
        c["frames"], "the G step's frames"
    out["loss_gap_first"], where["loss_gap_first"] = c["losses"][0]
    out["grad_gap"], where["grad_gap"] = max(
        (max(((v, k) for k, v in c[g]["grad"].items()), default=(0.0, ""))
         for g in GROUPS))
    for name, kind in (("grad_gap_median", "grad"),
                       ("update_gap_median", "update")):
        out[name], where[name] = max((median(c[g][kind]), g)
                                     for g in GROUPS)
    out["graph_grad_diff"], where["graph_grad_diff"] = \
        c["graph"]["diff"], "graph"
    return ({k: out[k] for k in CHECKS},
            [f"{k} worst at {where[k]}" for k in CHECKS])


def summary(c: Dict[str, Any]) -> Dict[str, Any]:
    """What `compare` found, in short: the worst loss gap of each checked
    iteration, and per Adam the 50, 90, 95 and 100% quantiles of the
    leaves' gradient and change gaps, the three worst leaves of each (gap,
    name), the leaves left out and the whole gradient's relative
    difference."""
    def q(d):
        return [float(np.quantile(list(d.values()), p))
                for p in (0.5, 0.9, 0.95, 1.0)] if d else []

    def worst(d):
        return sorted(((v, k) for k, v in d.items()), reverse=True)[:3]
    out: Dict[str, Any] = {"loss_by_iteration": c["losses"]}
    for g in GROUPS:
        out[g] = {"grad": q(c[g]["grad"]), "update": q(c[g]["update"]),
                  "worst_grad": worst(c[g]["grad"]),
                  "worst_update": worst(c[g]["update"]),
                  "left_out": c[g]["left_out"], "diff": c[g]["diff"]}
    return out


def host_state() -> Dict[str, float]:
    """What the host has done so far: this process's CPU seconds (every
    thread) and context switches, its threads, the load, the ms that a
    fixed loop of Python takes now (the speed of one core), and the host's
    CPU ticks, all and stolen, and its cores' mean clock (the last three
    from /proc, where there is one)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    t = time.perf_counter()
    sum(i * i for i in range(200_000))
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "forced": ru.ru_nivcsw,
           "voluntary": ru.ru_nvcsw, "load": os.getloadavg()[0],
           "loop_ms": 1e3 * (time.perf_counter() - t)}
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        out["mhz"] = sum(mhz) / len(mhz)
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:9]]
        out["ticks"], out["stolen"] = sum(ticks), ticks[7]
        with open("/proc/self/status") as f:
            out["threads"] = next(int(line.split()[1]) for line in f
                                  if line.startswith("Threads:"))
    except (OSError, ValueError, IndexError, StopIteration,
            ZeroDivisionError):
        pass
    return out


def host_note(before: Dict[str, float], after: Dict[str, float],
              seconds: float) -> str:
    """One line on what the host did between two `host_state`s."""
    line = (f"host in the window: this process's CPU "
            f"{after['cpu_s'] - before['cpu_s']:.2f} s in {seconds:.2f} s, "
            f"{after['forced'] - before['forced']} forced and "
            f"{after['voluntary'] - before['voluntary']} voluntary context "
            f"switches, load {before['load']:.2f} -> {after['load']:.2f}, "
            f"{len(os.sched_getaffinity(0))} CPUs, a fixed Python loop "
            f"{before['loop_ms']:.2f} -> {after['loop_ms']:.2f} ms")
    if "mhz" in before and "mhz" in after:
        line += f", clock {before['mhz']:.0f} -> {after['mhz']:.0f} MHz"
    if "ticks" in before and "ticks" in after:
        ticks = after["ticks"] - before["ticks"]
        stolen = after["stolen"] - before["stolen"]
        line += (f", {after['threads']} threads, stolen "
                 f"{100 * stolen / max(ticks, 1):.2f}% of the host's CPU "
                 f"time")
    return line


def upload(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def reference_readings(config, traffic, seed, rings, device, prec=None,
                       perturb: float = 0.0) -> Dict[str, Any]:
    """The reference's readings of the first `check_steps` iterations from
    the seed's weights, in fp32 with TF32 and cuDNN off (`prec` rounds the
    contraction operands: the control; `perturb` scales every weight by
    1 + perturb * N(0, 1), to read how far the numbers move with it). In
    fp32 also the first iteration's frames generated in bf16."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference(config, traffic, prec).to(device)
        state = weights.make_state(training_spec(config, traffic), seed,
                                   device)
        if perturb:
            g = torch.Generator(device=device).manual_seed(1)
            for v in state.values():
                v.mul_(1 + perturb * torch.randn(v.shape, generator=g,
                                                 device=device))
        ref.load_state_dict(state)
        del state
        ref.reset_optimizers()
        named = {g: dict(ws) for g, ws in ref.groups().items()}
        start = {n: p.detach().clone() for ws in named.values()
                 for n, p in ws.items()}
        out: Dict[str, Any] = {"losses": []}
        # Without cuDNN: its heuristics pick FFT convs for fp32 without
        # TF32, far slower at these shapes (see generate.check_outputs).
        with torch.backends.cudnn.flags(enabled=False):
            if prec is None:
                out["frames_bf16"] = ref.generated_frames(
                    upload(rings[0][0], device), "bfloat16").cpu()
            for i in range(traffic["check_steps"]):
                b, gb = rings[i % len(rings)]
                losses, grads = ref.iteration(upload(b, device),
                                              upload(gb, device))
                out["losses"].append(losses_of(losses))
                if i == 0:
                    out["frames"] = ref.frames.cpu()
                    out["grads"] = on_host(grads)
                    out["first"] = {g: leaf_norms(out["grads"][g])
                                    for g in GROUPS}
                del grads
        out["change"] = change_norms(named, start)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]


def iteration(trainer, pair) -> Dict[str, torch.Tensor]:
    """What `Trainer.fit` runs for one step: a train step, a graph step."""
    out = dict(trainer.train_step(pair[0]))
    out.update(trainer.graph_step(pair[1]))
    return out


def iteration_flops(config, traffic, pair) -> int:
    """FLOPs of one iteration's forwards and backwards (the reference's,
    on meta; the Adams' elementwise work not counted)."""
    with torch.device("meta"):
        ref = reference(config, traffic)
        ref.reset_optimizers()
    t = {k: {n: torch.empty(v.shape, device="meta",
                            dtype=torch.float32 if v.dtype.kind == "f"
                            else torch.long) for n, v in b.items()}
         for k, b in zip(("b", "g"), pair)}
    with FlopCounterMode(display=False) as counter:
        ref.iteration(t["b"], t["g"], update=False)
    return int(counter.get_total_flops())


def raster_shapes(config, cfg, traffic) -> List[Tuple[int, ...]]:
    """(N, O, D, H, W) of each rasterizer launch of one iteration: the
    discriminator draws the judged frames' layouts once a call, in the G
    step and in each D step; on the dense frontend the generator draws the
    B*T frames' layouts too."""
    B, T = traffic["batch"], traffic["frames"]
    O = traffic["max_objects"]
    H, W = traffic["image_size"]
    n = B * (T - (cfg.n_frames_G - 1))
    shapes = [(n, O, 2 * cfg.gconv_dim, H, W)] * (
        1 + max(cfg.D_steps_per_G, 1))
    if not cfg.factorized_frontend:
        n_attr = len(config["vocab"]["attributes"])
        D = (gen.APPEARANCE_DIM // n_attr) * n_attr + cfg.gconv_dim
        shapes.append((B * T, O, D, H, W))
    return shapes


@contextlib.contextmanager
def generated_frames(trainer):
    """Inside the block, the frames of every G step's train forward (B,
    T - ncond, H, W, 3) are appended to the list it yields: the trainer's
    `generator_backward` is shadowed by one that keeps them and returns
    what it returned."""
    frames: List[torch.Tensor] = []
    ncond = trainer.cfg.n_frames_G - 1
    own = trainer.__dict__.get("generator_backward")
    backward = trainer.generator_backward

    def keep(b):
        losses, out = backward(b)
        frames.append(out["imgs_pred"][:, ncond:].detach().float().clone())
        return losses, out
    trainer.generator_backward = keep
    try:
        yield frames
    finally:
        if own is None:
            del trainer.generator_backward
        else:
            trainer.generator_backward = own


def program_readings(trainer, rings, start, steps: int) -> Dict[str, Any]:
    """The program's readings of its first `steps` iterations from the
    weights `start` (just loaded, fresh Adams), on the ring's first
    batches: the frames the first G step generates, the losses of each,
    the first gradient of each Adam and each weight's change after
    them."""
    named, _ = program_groups(trainer)
    out: Dict[str, Any] = {}
    kept = []
    for i in range(steps):
        if i > 0:
            kept.append(iteration(trainer, rings[i % len(rings)]))
            continue
        with generated_frames(trainer) as frames:
            kept.append(iteration(trainer, rings[0]))
        out["frames"] = frames[0].cpu() if frames else None
        out["grads"] = first_gradients(trainer)
        out["first"] = {g: leaf_norms(out["grads"][g]) for g in GROUPS}
    out["change"] = change_norms(named, start)
    out["losses"] = [losses_of(m) for m in kept]
    return out


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", fault=None) -> Dict[str, Any]:
    """One run of a training cell; see the module docstring. `fault`, a
    test's hook, gets the trainer and may break it."""
    from ag2video_torch.train import Trainer

    config, traffic = cell["config"], cell["traffic"]
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    marks = [("imports", time.monotonic())]
    cfg, vocab = train_config(config, traffic)
    trainer = Trainer(cfg, vocab, device=device)
    trainer.init()
    sync()
    marks.append(("the program's trainer", time.monotonic()))
    state = weights.make_state(training_spec(config, traffic), seed, device)
    load_program(trainer, state)
    if fault is not None:
        fault(trainer)
    rings = make_rings(config, traffic, seed)
    sync()
    marks.append(("seeded weights and inputs", time.monotonic()))

    # The first iterations from the seed, on distinct batches, through the
    # calls and the feed the window times: the check's readings.
    K = len(rings)
    prog = program_readings(trainer, rings, state, traffic["check_steps"])
    del state
    for i in range(traffic["check_steps"], traffic["warmup"]):
        iteration(trainer, rings[i % K])
    skipped_setup = trainer.skipped_nan
    sync()
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    setup_s = time.monotonic() - t_start
    marks.append(("warm-up", t_start + setup_s))
    host = [host_state()]

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    host_s: List[float] = []
    attempted = failed = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        pair = rings[(traffic["warmup"] + attempted) % K]
        before = trainer.skipped_nan
        ts = time.perf_counter()
        attempted += 1
        try:
            iteration(trainer, pair)
        except RuntimeError:
            failed += 1
        else:
            failed += trainer.skipped_nan > before
        host_s.append(time.perf_counter() - ts)
        if time.perf_counter() >= deadline:
            break
    sync()
    window_s = time.perf_counter() - t0
    host.append(host_state())
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    completed = attempted - failed
    B = traffic["batch"]
    out: Dict[str, Any] = {
        "attempted": attempted, "failed": failed,
        "e2e": {"train_samples_per_s": completed * B / window_s},
        "setup_s": setup_s, "memory_peak_bytes": max(setup_peak, window_peak),
        "notes": [f"{attempted} iterations in {window_s:.3f} s (closed loop, "
                  f"B={B}, T={traffic['frames']}, graph T="
                  f"{4 * traffic['train']['frames_per_action_graph']})",
                  power_limit() if on_card else "cpu",
                  "set-up s: " + ", ".join(
                      f"{name} {t - prev:.3f}" for prev, (name, t)
                      in zip([t_start] + [t for _, t in marks], marks))
                  + f" (this process's CPU {host[0]['cpu_s']:.2f} s)",
                  host_note(host[0], host[1], window_s)]}
    if skipped_setup:
        out["notes"].append(f"the NaN guard skipped {skipped_setup} steps "
                            f"of the checked iterations")

    if trace:
        ctx: Dict[str, Any] = {
            "calls": completed, "window_s": window_s, "host_s": host_s,
            "flops_per_call": iteration_flops(config, traffic, rings[0]),
            "peak_bytes": window_peak,
            "raster_shapes": raster_shapes(config, cfg, traffic)}
        if on_card:
            from benchmark.trace import trace_calls
            at = iter(range(10 ** 9))
            ctx["slice"] = trace_calls(
                lambda: iteration(trainer, rings[next(at) % K]),
                traffic["trace_calls"], sync, os.environ.get("TMPDIR"))
            launches = ctx["slice"].seconds_of(r"rasterize")[1]
            want = len(ctx["raster_shapes"]) * ctx["slice"].calls
            if launches != want:
                out["notes"].append(
                    f"the trace shows {launches} rasterizer launches, the "
                    f"configuration {want}: train_raster_roofline reads "
                    f"nothing")
        out["ctx"] = ctx

    # The program's state goes before the reference runs.
    del trainer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = reference_readings(config, traffic, seed, rings, device)
    c = compare(prog, ref)
    checks, where = numbers(c)
    if skipped_setup:
        checks = {k: math.inf for k in CHECKS}
    out["notes"] += where
    d = summary(c)
    out["notes"].append(
        "not compared: loss gaps by iteration "
        + ", ".join(f"{v!r} ({t})" for v, t in d["loss_by_iteration"])
        + "; whole first gradient ||d|| / ||ref|| "
        + ", ".join(f"{g} {d[g]['diff']!r}" for g in GROUPS)
        + "; worst leaf's change gap "
        + ", ".join(f"{g} {d[g]['update'][-1]!r}" for g in GROUPS))
    out["notes"].append(f"the reference took {time.perf_counter() - r0:.1f}"
                        f" s for {traffic['check_steps']} iterations")
    out["checks"] = checks
    out["compared_clips"] = traffic["check_steps"] * B
    return out
