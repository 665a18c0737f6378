#!/usr/bin/env python3
"""Time chip_smoke.py's generation and training phases in two or more
checkouts, in turns, on one CUDA card.

    python3 torch_tools/ab_phases.py ROOT [ROOT ...] [--log FILE]

Runs every ROOT in the order given, then in reverse (A B B A for two
roots), each in a fresh process that imports that root's chip_smoke.py and
runs its phases 1 (the builds), 5 and 7 (generation, dense and factorized
frontend), 9 (the training iteration), 10 (the training run) and 14 (the
training modes). Each line a phase prints comes out prefixed with its root
and its turn, and is appended to FILE when given. Compare two trees only
within one such run: the card's clock and the host's load move between
runs.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = """
import os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_card()
cs.phase_full(factorized=False)
cs.phase_full(factorized=True)
p9 = cs.phase_train_full()
with tempfile.TemporaryDirectory() as tmp:
    cs.phase_fit(p9["ms"], os.path.join(tmp, "run"))
cs.phase_modes(p9)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts holding chip_smoke.py")
    ap.add_argument("--log", default=None, help="append every line here")
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.roots]
    for r in roots:
        if not os.path.isfile(os.path.join(r, "chip_smoke.py")):
            raise SystemExit(f"ab_phases: no chip_smoke.py in {r}")
    log = open(args.log, "a") if args.log else None
    rc = 0
    for turn, root in enumerate(roots + roots[::-1]):
        tag = f"[{os.path.basename(root) or root} turn {turn + 1}]"
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.Popen([sys.executable, "-c", CHILD], cwd=root,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            out = f"{tag} {line.rstrip()}"
            print(out, flush=True)
            if log:
                log.write(out + "\n")
                log.flush()
        if proc.wait() != 0:
            print(f"{tag} exited {proc.returncode}", flush=True)
            rc = 1
    if log:
        log.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
