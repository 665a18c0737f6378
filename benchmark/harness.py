"""Runs one cell of BENCHMARK.json once and prints its result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is found by name: `configs/<config>.json`, `traffic/<traffic>.json` (whose
`driver` names `drivers/<driver>.py`), `limits/<cell>.json` (the limit of
each number compared) and `metrics/<stem>.py` for a per-layer metric
`<stem>.<suffix>` (its `read(ctx)` returns the value, or None where it
finds nothing to read; the metric is then left out of the line).
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ag2video_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(man: Dict[str, Any], name: str) -> Dict[str, Any]:
    """The cell's entry with its configuration, traffic and limits."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", name + ".json"))
    return {"name": name, "entry": w, "config": config, "traffic": traffic,
            "limits": limits,
            "end_to_end": [m for m in man["end_to_end"] if applies(m, name)],
            "per_layer": [m for m in man["per_layer"] if applies(m, name)]}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def read_per_layer(cell, ctx) -> Dict[str, Dict[str, Any]]:
    """Each per-layer metric of the cell that its reader finds; one listed
    for the cell that reads nothing is named in `ctx["silent"]`."""
    out = {}
    ctx.setdefault("silent", [])
    for m in cell["per_layer"]:
        stem = m["name"].split(".")[0]
        reader = importlib.import_module(f"benchmark.metrics.{stem}")
        value = reader.read(ctx, m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            ctx["silent"].append(m["name"])
    return out


def judge(limits: Dict[str, float], readings: Dict[str, float],
          failed: int) -> Dict[str, Any]:
    """Each number compared beside its limit, and whether the run is
    correct: no call failed and no number passed its limit."""
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in readings.items()}
    correct = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return {"correct": bool(correct), "checks": checks}


def result(cell, res, trace: bool, device: Dict[str, Any]) -> Dict[str, Any]:
    """The result line of a driver's run `res`."""
    verdict = judge(cell["limits"], res["checks"], res["failed"])
    checks = verdict["checks"]
    line: Dict[str, Any] = {"correct": verdict["correct"],
                            "attempted": res["attempted"],
                            "failed": res["failed"]}
    if trace:
        ctx = res["ctx"]
        line["metrics"] = read_per_layer(cell, ctx)
        sl = ctx.get("slice")
        if sl is not None:
            device = dict(device, busy_s=sl.busy_s, window_s=sl.window_s)
            line["breakdown"] = {
                "device_ops": [[k, v] for k, v in sl.by_category()[:10]],
                "idle_gaps": [[k, v] for k, v in sl.idle_gaps()[:10]]}
    else:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        line["metrics"] = {}
        for m in cell["end_to_end"]:
            if m["name"] not in values:
                raise RuntimeError(f"{cell['name']}: the driver gave no "
                                   f"{m['name']}")
            line["metrics"][m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
    line["device"] = device
    line["checks"] = checks
    return line


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load_cell(manifest(), args.workload)
    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['traffic']['driver']}")
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), t_start)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = result(cell, res, bool(args.trace), device)

    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that the run must not load: {bad}",
              file=sys.stderr)
        return 3
    silent = res.get("ctx", {}).get("silent", [])
    if silent:
        res["notes"].append("listed for this cell but read nothing, so left "
                            "out of the line: " + ", ".join(silent))
    for note in res["notes"] + [f"compared {res['compared_clips']} clips"]:
        print(note, file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    line["checks"] = {k: {kk: (vv if math.isfinite(vv) else repr(vv))
                          for kk, vv in c.items()}
                      for k, c in line["checks"].items()}
    print(json.dumps(line, allow_nan=False))
    return 0
