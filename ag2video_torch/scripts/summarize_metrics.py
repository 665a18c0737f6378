"""Summarize a training run's metrics.jsonl: loss/sigma trajectories (a
copy of scripts/summarize_metrics.py, held to it by
tests/test_torch_cli.py; pure Python).

    python -m ag2video_torch.scripts.summarize_metrics output/run1 \
        [--keys G/total_loss ...]

Prints first/quartile/last values per key plus the sigma-drift summary used
by RESULTS.md's long-horizon stability evidence.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("--keys", nargs="*", default=[
        "G/total_loss", "D/total_img_loss", "Graph/total_loss", "G/VGG",
        "sigma/G_max", "sigma/G_mean", "sigma/D_max", "sigma/D_mean"])
    p.add_argument("--all", action="store_true",
                   help="print EVERY row per key (checkpoint-cadence keys "
                        "like use_gt/fidelity_fid, for trajectory tables)")
    args = p.parse_args(argv)

    path = os.path.join(args.run_dir, "metrics.jsonl")
    rows = [json.loads(l) for l in open(path)]
    out = {}
    for k in args.keys:
        vals = [(r.get("t", r.get("step", i)), r[k])
                for i, r in enumerate(rows) if k in r]
        if not vals:
            continue
        n = len(vals)
        pick = vals if args.all else [vals[0], vals[n // 4], vals[n // 2],
                                      vals[3 * n // 4], vals[-1]]
        out[k] = {f"@{t}": round(float(v), 4) for t, v in pick}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
