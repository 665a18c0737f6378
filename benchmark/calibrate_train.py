#!/usr/bin/env python3
"""Readings that the limits of a training cell are set from, and the
verdicts that the control and the planted faults get under them.

    python3 benchmark/calibrate_train.py --workload <cell> \\
        --seeds 11 12 ... [--control-seeds 21 22 23] [--faults] \\
        [--look] [--perturb 1e-6] [--out <file.jsonl>]

For each seed, at the cell's own shapes: the program's first
`check_steps` iterations from the seed's weights, on the seed's batches,
compared with the fp32 reference as a run compares them
(`drivers/train.gaps`; the lower readings). For each control seed, the
reference computed in fp8 (e4m3, per-tensor scales, forward operands) put
in the program's place, compared the same way (the upper readings), and
with `--faults` the program with each fault of benchmark/faults_train.py
planted. With `--look`, on every seed also the plain reference in bf16
and the program computing in fp32 (TF32 off), compared the same way:
how far rounding alone moves each number, and whether the program
departs from the reference where rounding does not hide it. The control and every fault are judged as a run is
(`harness.judge`, the cell's committed limits). One JSON line per seed,
then the largest program reading and the smallest control reading of
each number. One trainer serves every seed: its weights reloaded and its
Adams made anew. Needs one CUDA card; not part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import faults_train, harness, weights  # noqa: E402
from benchmark.drivers import train as drv  # noqa: E402

CONTROL = "float8_e4m3fn"


def fp32_config(config):
    """The configuration with the program computing in fp32."""
    return dict(config, model=dict(config["model"], compute_dtype="float32"))


def readings_fp32(trainer, cfg, state, rings, steps):
    """The fp32 program's readings, TF32 off as in the reference."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        fresh(trainer, cfg, state)
        return drv.program_readings(trainer, rings, state, steps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = tf32[1]


def fresh(trainer, cfg, state) -> None:
    """The seed's weights in the trainer, fresh Adams, no skipped step."""
    from ag2video_torch.train.state import reset_optimizers

    drv.load_program(trainer, state)
    reset_optimizers(trainer.state, cfg)
    trainer.state.skipped_nan = 0


def verdict(prog, ref, limits):
    c = drv.compare(prog, ref)
    nums, where = drv.numbers(c)
    return dict(nums, where=where, detail=drv.summary(c),
                correct=harness.judge(limits, nums, 0)["correct"])


def readings(cell, seeds, control_seeds, device="cuda", out=None,
             with_faults=False, perturb=0.0, look=False):
    """Per seed {'seed', 'program', 'control', 'faults', ...}: each
    number, and the verdict under the cell's limits."""
    from ag2video_torch.train import Trainer

    config, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    steps = traffic["check_steps"]
    cfg, vocab = drv.train_config(config, traffic)
    trainer = Trainer(cfg, vocab, device=device)
    trainer.init()
    if look:
        cfg32, _ = drv.train_config(fp32_config(config), traffic)
        trainer32 = Trainer(cfg32, vocab, device=device)
        trainer32.init()
    spec = drv.training_spec(config, traffic)
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        state = weights.make_state(spec, seed, device)
        rings = drv.make_rings(config, traffic, seed)
        ref = drv.reference_readings(config, traffic, seed, rings, device)
        row = {"seed": seed, "program": None, "control": None, "faults": {}}
        if seed in seeds:
            fresh(trainer, cfg, state)
            row["program"] = verdict(drv.program_readings(
                trainer, rings, state, steps), ref, limits)
            row["skipped"] = trainer.skipped_nan
            if look:
                row["program_fp32"] = verdict(readings_fp32(
                    trainer32, cfg32, state, rings, steps), ref, limits)
                row["bf16"] = verdict(drv.reference_readings(
                    config, traffic, seed, rings, device, "bfloat16"), ref,
                    limits)
            if perturb:
                row["perturbed"] = verdict(drv.reference_readings(
                    config, traffic, seed, rings, device, perturb=perturb),
                    ref, limits)
        if seed in control_seeds:
            ctl = drv.reference_readings(config, traffic, seed, rings,
                                         device, CONTROL)
            row["control"] = verdict(ctl, ref, limits)
            for name in (faults_train.ALL if with_faults else ()):
                fresh(trainer, cfg, state)
                faults_train.ALL[name](trainer)
                try:
                    got = drv.program_readings(trainer, rings, state,
                                               steps)
                except RuntimeError as e:
                    row["faults"][name] = {"correct": False,
                                           "raised": str(e)[:200]}
                    continue
                finally:
                    faults_train.restore()
                row["faults"][name] = verdict(got, ref, limits)
        del state
        if torch.cuda.is_available() and torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(dict(row, workload=cell["name"])) + "\n")
    summary = {}
    for k in drv.CHECKS:
        lo = [r["program"][k] for r in rows if r["program"]]
        up = [r["control"][k] for r in rows if r["control"]]
        fl = {n: min(r["faults"][n].get(k, float("inf")) for r in rows
                     if n in r["faults"])
              for n in faults_train.ALL if any(n in r["faults"]
                                               for r in rows)}
        summary[k] = {"lower": max(lo) if lo else None,
                      "upper": min(up) if up else None, "faults": fl}
        for side in ("program_fp32", "bf16", "perturbed"):
            got = [r[side][k] for r in rows if r.get(side)]
            if got:
                summary[k][side] = [min(got), max(got)]
    print(json.dumps({"workload": cell["name"], "summary": summary}))
    return rows, summary


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true",
                    help="also plant each fault on the control seeds")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="also read the fp32 reference with every weight "
                    "scaled by 1 + perturb * N(0, 1) on every seed")
    ap.add_argument("--look", action="store_true",
                    help="also read the bf16 reference and the fp32 "
                    "program on every seed")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate_train: needs a CUDA card")
    cell = harness.load_cell(harness.manifest(), args.workload)
    readings(cell, args.seeds, args.control_seeds, out=args.out,
             with_faults=args.faults, perturb=args.perturb, look=args.look)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
