#!/usr/bin/env python3
"""Readings that the limits of a generation cell are set from, and the
verdicts that the control and the planted faults get under them.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... \\
        [--control-seeds 21 22 23] [--faults] [--out <file.jsonl>]

For each seed, at the cell's own shapes: the program's `check_calls`
calls on the seed's batches and weights, compared with the fp32 reference
as a run compares them (the lower readings). For each control seed, the
reference computed in fp8 (e4m3, per-tensor scales) put in the program's
place, compared the same way (the upper readings), and with `--faults`
the program with each fault of benchmark/faults.py planted. The control
and every fault are judged as a run is (`harness.judge`, the cell's
committed limits). One JSON line per seed, then the largest program
reading and the smallest control reading of each number. Needs one CUDA
card; not part of a benchmark run.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import faults, harness, inputs, weights  # noqa: E402
from benchmark.drivers import generate as drv  # noqa: E402


def kept_outputs(model, ring, traffic):
    """The outputs of the `check_calls` calls, as a run keeps them; a call
    that raises makes them None."""
    from ag2video_torch.inference import generate

    kept = []
    for i in range(traffic["check_calls"]):
        slot = i % len(ring)
        try:
            imgs, boxes = generate(model, ring[slot])
        except RuntimeError:
            return None
        kept.append((slot, imgs, boxes))
    return kept


def readings(cell, seeds, control_seeds, device="cuda", out=None,
             with_faults=False):
    """Per seed {'seed', 'program', 'control', 'faults', ...}: each number's
    worst clip, and the verdict under the cell's limits."""
    from ag2video_torch.models import AG2VideoModel

    config, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    cfg, vocab = drv.port_config(config, traffic)
    model = AG2VideoModel(cfg, vocab, device=device)
    spec = drv.reference_spec(config)
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        model.load_state_dict(weights.make_state(spec, seed, device))
        ring = inputs.make_ring(config["vocab"], traffic, seed)
        control = seed in control_seeds
        errs = drv.check_outputs(
            config, traffic, seed, ring, kept_outputs(model, ring, traffic),
            device, "float8_e4m3fn" if control else None)
        row = {"seed": seed, "program": None, "control": None, "faults": {},
               "frames_err": {k: max(v["frames"]) for k, v in errs.items()},
               "program_median": {k: statistics.median(v) for k, v in
                                  errs["program"].items()}}
        for side, want in (("program", seed in seeds), ("control", control)):
            if want:
                got = drv.worst(errs, side)
                row[side] = dict(got, correct=harness.judge(
                    limits, got, 0)["correct"])
        for name in (faults.applicable(traffic["batch"])
                     if control and with_faults else ()):
            getattr(faults, name)(model)
            try:
                kept = kept_outputs(model, ring, traffic)
            finally:
                faults.restore()
            if kept is None:
                row["faults"][name] = {"correct": False, "raised": True}
                continue
            got = drv.worst(drv.check_outputs(config, traffic, seed, ring,
                                              kept, device))
            row["faults"][name] = dict(got, correct=harness.judge(
                limits, got, 0)["correct"])
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
        summary[k] = {"lower": max(lo) if lo else None,
                      "upper": min(up) if up else None}
    print(json.dumps({"workload": cell["name"], "summary": summary}))
    return rows, summary


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", action="store_true",
                    help="also plant each fault on the control seeds")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA card")
    cell = harness.load_cell(harness.manifest(), args.workload)
    readings(cell, args.seeds, args.control_seeds, out=args.out,
             with_faults=args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
