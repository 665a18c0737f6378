"""The generation driver, called in-process on the CPU at 32x32: a sound
run comes out correct with every metric; the control and planted faults
come out not correct; the command itself refuses to run without a card."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import calibrate, faults, harness
from benchmark.drivers import generate as gen
from benchmark.tests import tiny

E2E = [{"name": "frames_per_s", "unit": "frames/s"},
       {"name": "setup_s", "unit": "s"}]
LAYER = [{"name": f"{m}.gen", "unit": "u"} for m in
         ("host_ms", "rollout_ms", "frame_ms", "spade_ms", "mfu",
          "launches_per_call", "idle_pct", "peak_mem_gib",
          "rasterize_roofline")]


def _run(cell, trace=False, fault=None, seconds=0.5):
    res = gen.run(cell, 2 ** 31 + 99, seconds, trace, time.monotonic(),
                  device="cpu", fault=fault)
    return res, harness.result(cell, res, trace, {"platform": "cpu"})


@pytest.mark.parametrize("factorized", [True, False],
                         ids=["factorized", "dense"])
def test_a_sound_run_is_correct_and_reports_its_metrics(factorized):
    cell = tiny.cell(tiny.config(factorized_frontend=factorized),
                     end_to_end=E2E, per_layer=LAYER)
    res, line = _run(cell)
    assert line["correct"] and line["failed"] == 0
    assert res["compared_clips"] == 2 * cell["traffic"]["batch"]
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
    res, line = _run(cell, trace=True)
    assert line["correct"]
    # On the CPU: no trace slice, no device peak; the spans and the
    # host-side numbers are read.
    assert set(line["metrics"]) == {"host_ms.gen", "rollout_ms.gen",
                                    "frame_ms.gen", "spade_ms.gen",
                                    "mfu.gen"}
    assert len(res["ctx"]["spans"]["frame"]) == \
        cell["traffic"]["span_calls"] * (cell["traffic"]["frames"] - 1)


def test_latency_loop_reports_the_p95_of_every_call():
    cell = tiny.cell(trf=tiny.traffic(loop="latency", batch=1),
                     end_to_end=[{"name": "clip_ms_p95", "unit": "ms"},
                                 {"name": "setup_s", "unit": "s"}])
    res, line = _run(cell)
    assert line["correct"]
    assert line["metrics"]["clip_ms_p95"]["value"] > 0
    assert res["attempted"] >= 1


@pytest.mark.parametrize("fault", list(faults.ALL))
def test_a_broken_timed_path_is_not_correct(fault):
    cell = tiny.cell(end_to_end=E2E)
    try:
        _, line = _run(cell, fault=faults.ALL[fault])
    finally:
        faults.restore()
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_the_control_fails_where_the_program_passes():
    """The reference in fp8 in the program's place reads past the program's
    bf16 readings by 3x or more at 32x32 (the cells' limits are set from
    the card's readings at their own sizes)."""
    cell = tiny.cell(tiny.config(dtype="bfloat16"),
                     tiny.traffic(check_calls=1))
    _, summary = calibrate.readings(cell, [1, 2, 3], [1, 2, 3],
                                    device="cpu")
    assert summary["frames_gap_x_bf16"]["upper"] >= \
        3 * summary["frames_gap_x_bf16"]["lower"]


def test_calibrate_judges_the_control_and_the_faults_as_a_run_does():
    """calibrate.readings judges the program, the control and every fault
    by the cell's limits, as harness.result does."""
    cell = tiny.cell()
    rows, _ = calibrate.readings(cell, [1], [1], device="cpu",
                                 with_faults=True)
    (r,) = rows
    assert r["program"]["correct"]
    assert not r["control"]["correct"]
    assert set(r["faults"]) == set(faults.ALL)
    assert not any(f["correct"] for f in r["faults"].values())


def test_the_command_needs_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    wl = harness.manifest()["workloads"][0]["name"]
    cmd = [sys.executable, os.path.join(tiny.BENCH, "run.py"), "--workload",
           wl, "--seed", "1", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       cwd=harness.ROOT, timeout=120)
    assert p.returncode != 0
    for out in p.stdout.strip().splitlines()[-1:]:
        with pytest.raises(json.JSONDecodeError):
            json.loads(out)
