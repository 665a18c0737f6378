"""On the card, at the training cell's own size: on three seeds the program
passes the cell's committed limits, while the control (the reference in
fp8 in the program's place) and each fault of benchmark/faults_train.py
come out not correct under them; one short run of the cell prints a
correct result line with every per-layer metric. Marked `gpu`; skips
without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import calibrate_train, faults_train, harness
from benchmark.tests import tiny

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]
         if tiny.load(f"traffic/{w['traffic']}.json")["driver"] == "train"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_and_program_passes_at_cell_size(card, name):
    cell = harness.load_cell(MAN, name)
    rows, _ = calibrate_train.readings(cell, [101, 102, 103],
                                       [101, 102, 103], with_faults=True)
    for r in rows:
        assert r["program"]["correct"], r
        assert not r["control"]["correct"], r
        assert set(r["faults"]) == set(faults_train.ALL)
        assert not any(f["correct"] for f in r["faults"].values()), r


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_prints_a_correct_line(card, name):
    cmd = [sys.executable, os.path.join(tiny.BENCH, "run.py"),
           "--workload", name, "--seed", str(2 ** 31 + 17), "--seconds", "3",
           "--trace", "1"]
    p = subprocess.run(cmd, capture_output=True, text=True,
                       cwd=harness.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], p.stderr[-4000:]
    want = {m["name"] for m in MAN["per_layer"]
            if harness.applies(m, name)}
    assert set(line["metrics"]) == want
    assert line["device"]["busy_s"] > 0
