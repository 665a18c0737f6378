#!/usr/bin/env python3
"""Hold the port's first 8 training iterations to the JAX package's.

    python3 torch_tools/trajectory.py [--device cpu] [--threads 1 2 4]
                                                  # the card by default

torch_tools/data/reference_trajectory_64.npz (written where JAX runs by
`torch_tools/make_reference_npz.py trajectory`) holds 8 JAX iterations
(`train_step` then `graph_step`) at 64x64 and lr 1e-5 from the port's
seeded reference weights, per compute dtype, and the reference's own
spread: how far each quantity moves when the rounding moves (the inputs
and every weight element scaled by 1 + eps and 1 + eps * N(0, 1), eps
1e-6 in fp32 and 2^-8 in bf16; the largest of 4 such runs).
`run_port(ref, dtype, device)` runs the same iterations on the port's
`Trainer` (`chip_smoke.reference_trainer`, the same batches) and `check`
(`compare`) holds them to the reference:

  metrics      every G, D and Graph metric of each iteration, as
               |port - JAX| / max(|JAX|, 1); its spread at iteration k is
               the largest up to k (the perturbed runs' distance from the
               first dips below its level now and then, as two chaotic
               runs cross)
  lr           the G, D and graph learning rates of each update, within
               LR_RTOL
  state        each BN statistic and spectral u / sigma after iteration
               8, as the leaf's relative L2 error
  update_norm  the L2 norm of each network's whole update (final -
               initial), relative
  update       each parameter's update, as a relative L2 error estimated
               from the file's norm and two random projections: max(|
               ||u|| - ||u_ref|| |, rms of the projections' differences) /
               ||u_ref|| (each projection's expected square is the squared
               error); `update_total` each network's whole update
  sigma        each SpectralWeight's exact top singular value after
               iteration 8 (torch_tools/sigma_audit.py against
               tools/sigma_audit.py's, stored in the file), relative

Each quantity's bound is the larger of SPREAD_FACTOR times its own spread
(in the same measure) and the dtype's floor (FLOORS): the one-step bounds
already in use, fp32's from tests/test_torch_train.py (losses 1e-4 on the
first iteration, 1e-3 after; state 1e-5; G's gradients 1e-2 rel-L2 for the
updates) and bf16's from chip_smoke.py phase 14 (losses 1e-2; state 3e-2,
for the updates too). A quantity holds when its error is within its bound
and the bound is below 1 (`held`): every error is relative, so a bound of
1 or more passes a port that does nothing, and such a quantity is
unpinned: counted, held by nothing. Most single parameters' updates are
unpinned: Adam moves each element by about lr whatever the size of its
gradient, so where a gradient is at the level of rounding (a bias before
a normalisation, G's ill-conditioned BatchNorms at these widths) its sign
and the update's direction are a draw. The quantities of KNOWN_GAPS do not
hold (see there): `check` reports them and raises on any other past its
bound. With --threads the port also runs against itself at other CPU
thread counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ag2video_torch import Config, get_vocab  # noqa: E402
from ag2video_torch.flax_npz import unflatten_variables  # noqa: E402
from ag2video_torch.inference import make_inputs  # noqa: E402
from ag2video_torch.train.state import learning_rate  # noqa: E402
from ag2video_torch.weights import flax_to_state_dict  # noqa: E402
from torch_tools.sigma_audit import spectral_rows  # noqa: E402

REFERENCE = os.path.join(ROOT, "torch_tools", "data",
                         "reference_trajectory_64.npz")
DTYPES = ("float32", "bfloat16")
SPREAD_FACTOR = 4.0
FLOORS = {
    "float32": dict(metric_first=1e-4, metric=1e-3, state=1e-5,
                    update=1e-2),
    "bfloat16": dict(metric_first=1e-2, metric=1e-2, state=3e-2,
                     update=3e-2),
}
LR_RTOL = 1e-6
# The quantities the port does not hold, (dtype, category, quantity) ->
# the gap as measured on the CPU (2 threads, where the runs are
# deterministic) by this script. Not a fault of the port's: in bf16, XLA on
# the CPU reduces a broadcast's transpose (a bias's gradient) in bf16, and
# D's last bias gradient stalls at -0.25 where the fp32 value is +0.032
# (the port, accumulating in fp32, gets +0.031), so the reference moves
# that bias by +lr every step (ROADMAP.md section 3).
KNOWN_GAPS: Dict[Tuple[str, str, str], str] = {
    ("bfloat16", "update", "D:discriminator_0.model2.bias"):
        "1.542 rel-L2 (bound 3e-2, 51x): D's last bias, moved by +lr a step "
        "in the reference",
    ("bfloat16", "update", "D:discriminator_1.model2.bias"):
        "3.223e-02 rel-L2 (bound 3e-2, 1.07x): D's other last bias, the "
        "same reduction",
}
CATEGORIES = ("metrics", "lr", "state", "update_norm", "update",
              "update_total", "sigma")
NETS = {"model": ("model_state", "G"), "disc": ("d_state", "D")}


def load_reference(path: str = REFERENCE) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def config(ref: Dict[str, np.ndarray], dtype: str) -> Config:
    return Config.from_dict(dict(json.loads(str(ref["config"])),
                                 compute_dtype=dtype))


def projections(key: str, update: np.ndarray) -> np.ndarray:
    """[||update||, r1 . update, r2 . update] in float64, r1 and r2 N(0, 1)
    vectors of update's size drawn from RandomState(crc32(key)), over the
    C-order flattening of the port's layout (the reference file stores
    these of the JAX run's updates)."""
    u = np.asarray(update, np.float64).ravel()
    r = np.random.RandomState(zlib.crc32(key.encode())).standard_normal(
        (2, u.size))
    return np.concatenate([[np.linalg.norm(u)], r @ u])


def run_port(ref: Dict[str, np.ndarray], dtype: str, device
             ) -> Dict[str, Any]:
    """The port's iterations at the file's configuration in `dtype` compute
    on `device` -> {metrics: {name: (K,)}, lr: {G/D/Graph: (K,)}, trainer,
    initial: {net: {name: fp32 parameter on the CPU}}}."""
    from chip_smoke import reference_trainer

    cfg = config(ref, dtype)
    vocab = get_vocab(cfg.dataset)
    trainer = reference_trainer(cfg, vocab, device)
    st = trainer.state
    initial = {net: {k: p.detach().float().cpu().clone()
                     for k, p in getattr(st, net).named_parameters()}
               for net in NETS}
    opts = {"G": st.opt_gen, "D": st.opt_d, "Graph": st.opt_graph}
    metrics: Dict[str, List[float]] = {}
    lrs: Dict[str, List[float]] = {k: [] for k in opts}
    B = cfg.batch_size
    for ts, gs in zip(ref["train_seeds"], ref["graph_seeds"]):
        batch = make_inputs(cfg, vocab, B, cfg.frames_per_action,
                            seed=int(ts))
        graph = make_inputs(cfg, vocab, B, 4 * cfg.frames_per_action_graph,
                            seed=int(gs))
        for k, opt in opts.items():
            lrs[k].append(learning_rate(cfg, opt.count, opt.scale_decayed))
        m = trainer.train_step(batch)
        m.update(trainer.graph_step(graph))
        for k, v in m.items():
            metrics.setdefault(k, []).append(float(v))
    return dict(metrics={k: np.asarray(v) for k, v in metrics.items()},
                lr={k: np.asarray(v) for k, v in lrs.items()},
                trainer=trainer, initial=initial)


def _rel(err: float, scale: float) -> float:
    return err / scale if scale > 0 else (0.0 if err == 0 else np.inf)


def compare(ref: Dict[str, np.ndarray], dtype: str, port: Dict[str, Any]
            ) -> Dict[str, List[Tuple[str, float, float]]]:
    """{category: [(quantity, error, bound)]} of the port's run against the
    reference's (module docstring); raises on a quantity missing on
    either side."""
    floors = FLOORS[dtype]
    spread = lambda k: float(ref[f"spread/{dtype}/{k}"])
    bound = lambda s, floor: max(SPREAD_FACTOR * s, floor)
    out: Dict[str, List[Tuple[str, float, float]]] = {c: [] for c in
                                                       CATEGORIES}

    prefix = f"{dtype}/metrics/"
    want = {k[len(prefix):]: ref[k] for k in ref if k.startswith(prefix)}
    if set(want) != set(port["metrics"]):
        raise AssertionError(f"{dtype}: metrics {sorted(want)} vs "
                             f"{sorted(port['metrics'])}")
    for name, w in want.items():
        # two runs that have come apart do not come together again: the
        # spread at iteration k is the largest up to k
        s = np.maximum.accumulate(ref[f"spread/{dtype}/metrics/{name}"])
        for k, (g, wk) in enumerate(zip(port["metrics"][name], w)):
            scale = max(abs(float(wk)), 1.0)
            floor = floors["metric_first" if k == 0 else "metric"]
            out["metrics"].append((f"{name}@{k + 1}",
                                   abs(g - float(wk)) / scale,
                                   bound(float(s[k]) / scale, floor)))
    for name, got in port["lr"].items():
        for k, (g, w) in enumerate(zip(got, ref[f"{dtype}/lr/{name}"])):
            out["lr"].append((f"{name}@{k + 1}", abs(g - w) / w, LR_RTOL))

    st = port["trainer"].state
    for net, (field, tag) in NETS.items():
        module = getattr(st, net)
        state = module.state_dict()
        prefix = f"{dtype}/{field}/"
        for k in [k for k in ref if k.startswith(prefix)]:
            flax_key = k[len(prefix):]
            (pk, w), = flax_to_state_dict(
                unflatten_variables({flax_key: ref[k]})).items()
            w = w.double()
            err = float((state[pk].detach().double().cpu() - w).norm())
            scale = float(w.norm())
            out["state"].append((
                f"{tag}:{pk}", _rel(err, scale),
                bound(_rel(spread(f"{field}/{flax_key}"), scale),
                      floors["state"])))
        num = den = got_sq = 0.0
        for pk, p in module.named_parameters():
            key = f"{net}/{pk}"
            w = ref[f"{dtype}/update/{key}"]
            g = projections(key, (p.detach().float().cpu()
                                  - port["initial"][net][pk]).numpy())
            err = max(abs(g[0] - w[0]),
                      float(np.sqrt(np.mean((g[1:] - w[1:]) ** 2))))
            out["update"].append((
                f"{tag}:{pk}", _rel(err, w[0]),
                bound(_rel(spread(f"update/{key}"), w[0]),
                      floors["update"])))
            num += err * err
            den += w[0] * w[0]
            got_sq += g[0] * g[0]
        out["update_norm"].append((
            tag, _rel(abs(got_sq ** 0.5 - den ** 0.5), den ** 0.5),
            bound(_rel(spread(f"update_norm/{net}"), den ** 0.5),
                  floors["update"])))
        out["update_total"].append((
            tag, _rel(num ** 0.5, den ** 0.5),
            bound(_rel(spread(f"update_total/{net}"), den ** 0.5),
                  floors["update"])))
        prefix = f"{dtype}/sigma_true/{tag}/"
        want = {k[len(prefix):]: float(ref[k]) for k in ref
                if k.startswith(prefix)}
        rows = {p: t for p, _, t in spectral_rows(module)}
        if set(rows) != set(want):
            raise AssertionError(f"{dtype}: {tag} spectral kernels differ: "
                                 f"{sorted(set(rows) ^ set(want))[:4]}")
        for path, w in want.items():
            out["sigma"].append((
                f"{tag}:{path}", abs(rows[path] - w) / w,
                bound(spread(f"sigma_true/{tag}/{path}") / w,
                      floors["state"])))
    return out


def reference_sigma_rows(ref: Dict[str, np.ndarray], dtype: str
                         ) -> Dict[str, List[Tuple[str, float, float]]]:
    """The JAX run's audit after iteration 8, {"G"/"D": [(kernel path,
    stored sigma, exact top singular value)]}: the sigma from the file's
    norm state, the singular value tools/sigma_audit.py took of its
    kernel."""
    out = {}
    for net, (field, tag) in NETS.items():
        prefix = f"{dtype}/{field}/spectral/"
        hats = {}
        for k in ref:
            if k.startswith(prefix) and k.endswith("/sigma"):
                (pk, v), = flax_to_state_dict(unflatten_variables(
                    {k[len(f"{dtype}/{field}/"):]: ref[k]})).items()
                hats[pk] = float(v)
        prefix = f"{dtype}/sigma_true/{tag}/"
        out[tag] = [(k[len(prefix):], hats[".".join(
            k[len(prefix):].split("/")[:-2]) + ".spectral.sigma"],
            float(ref[k])) for k in sorted(ref) if k.startswith(prefix)]
    return out


def held(row: Tuple[str, float, float]) -> bool:
    """A quantity holds when its error is within its bound and the bound is
    below 1: every error here is relative, so a bound of 1 or more passes a
    port that does nothing (a zero update, a zero loss) and holds
    nothing."""
    return row[1] <= row[2] < 1.0


def summary(rows: List[Tuple[str, float, float]]) -> Dict[str, Any]:
    """The pinned quantities' worst (by error over bound) and median error
    and bound, those past their bounds (`over`), and those whose bound is 1
    or more (`unpinned`: the reference cannot pin them down)."""
    pinned = [r for r in rows if r[2] < 1.0]
    worst = max(pinned or rows, key=lambda r: r[1] / r[2])
    return dict(n=len(rows), worst=worst[0], worst_err=worst[1],
                worst_bound=worst[2],
                median_err=float(np.median([r[1] for r in pinned or rows])),
                median_bound=float(np.median([r[2] for r in pinned or rows])),
                over=[r for r in pinned if not held(r)],
                unpinned=[r for r in rows if not r[2] < 1.0])


def check(ref: Dict[str, np.ndarray], dtype: str, port: Dict[str, Any],
          gaps=KNOWN_GAPS) -> Dict[str, Dict[str, Any]]:
    """The port's run (`run_port`) against the reference -> {category:
    summary}; raises an AssertionError naming every quantity past its
    bound but the (dtype, category, quantity) entries of `gaps`."""
    bad = [m for m in port["metrics"].values() if not np.isfinite(m).all()]
    if bad or port["trainer"].skipped_nan:
        raise AssertionError(f"{dtype}: non-finite metrics or skipped steps")
    report = {c: summary(rows) for c, rows in
              compare(ref, dtype, port).items()}
    over = [(c, r) for c, s in report.items() for r in s["over"]
            if (dtype, c, r[0]) not in gaps]
    if over:
        raise AssertionError(
            f"{dtype} compute: {len(over)} quantities past their bounds: "
            + "; ".join(f"{c} {n} {e:.3e} > {b:.3e}"
                        for c, (n, e, b) in over[:12]))
    return report


def format_report(report: Dict[str, Dict[str, Any]], dtype: str,
                  gaps=KNOWN_GAPS) -> str:
    """One clause per category: the count of quantities, how many hold,
    how many are past their bounds (and of those, gaps of `gaps`), how many
    are unpinned; the worst pinned one (by error over bound) and the
    median."""
    def counts(c, s):
        over = s["over"]
        gap = sum((dtype, c, r[0]) in gaps for r in over)
        held_n = s["n"] - len(over) - len(s["unpinned"])
        return (f"{s['n']}: {held_n} held, {len(over)} past"
                + (f" ({gap} gaps)" if gap else "")
                + (f", {len(s['unpinned'])} unpinned" if s["unpinned"]
                   else ""))

    return "; ".join(
        f"{c} ({counts(c, s)}) worst {s['worst_err']:.3e} of bound "
        f"{s['worst_bound']:.3e} ({s['worst']}), median "
        f"{s['median_err']:.3e} of {s['median_bound']:.3e}"
        for c, s in report.items())


def self_difference(a: Dict[str, Any], b: Dict[str, Any]) -> str:
    """Two port runs of the same iterations against each other: per
    iteration the largest metric difference over max(|metric|, 1), and
    each network's whole update, relative L2."""
    K = len(next(iter(a["metrics"].values())))
    per_k = [max(abs(a["metrics"][n][k] - b["metrics"][n][k])
                 / max(abs(a["metrics"][n][k]), 1.0) for n in a["metrics"])
             for k in range(K)]
    totals = []
    for net in NETS:
        num = den = 0.0
        mods = [getattr(r["trainer"].state, net) for r in (a, b)]
        for (k, p), q in zip(mods[0].named_parameters(),
                             mods[1].parameters()):
            ua = p.detach().float().cpu() - a["initial"][net][k]
            ub = q.detach().float().cpu() - b["initial"][net][k]
            num += float((ua - ub).double().norm() ** 2)
            den += float(ua.double().norm() ** 2)
        totals.append(f"{NETS[net][1]} {(num / den) ** 0.5:.3e}")
    return ("metrics by iteration " + " ".join(f"{x:.2e}" for x in per_k)
            + "; whole update " + ", ".join(totals))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cpu, or a CUDA device (default: the card)")
    p.add_argument("--threads", type=int, nargs="*", default=[],
                   help="CPU threads of each run (one run per count; the "
                   "runs after the first are also compared with it)")
    args = p.parse_args(argv)
    device = torch.device("cuda" if args.device is None else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("trajectory: no CUDA card; pass --device cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = load_reference()
    for dtype in DTYPES:
        runs = []
        for n in args.threads or [torch.get_num_threads()]:
            torch.set_num_threads(n)
            runs.append(run_port(ref, dtype, device))
            report = {c: summary(rows) for c, rows in
                      compare(ref, dtype, runs[-1]).items()}
            print(f"{dtype} compute, {n} threads: "
                  f"{format_report(report, dtype)}")
            if len(runs) > 1:
                print(f"  against {args.threads[0]} threads: "
                      f"{self_difference(runs[0], runs[-1])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
