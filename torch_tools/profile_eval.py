#!/usr/bin/env python3
"""Where the evaluation networks spend their device time.

    python3 torch_tools/profile_eval.py [inception] [lpips_alex] [tsm] [resnext3d]

For each network named (all four by default) this builds chip_smoke.py
phase 13's call: the network from a seeded asset (torch_tools/
eval_assets.py, written to a temporary directory) on the card, at the
shape scripts.evaluate gives it (InceptionV3 at 299x299, LPIPS at 64x64,
both video backbones on 16x112x112 clips), B=8, fp32 with TF32 off; then
torch_tools/profile_generate.py's measure (`profile_calls`: 2 warm-up
calls, 5 unprofiled timed ones, 3 traced with `torch.profiler`): device
kernel time by category, kernels and aten ops per call, the device-busy
share, the 12 largest kernels, and one JSON line. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch_tools.eval_assets import write_assets  # noqa: E402
from torch_tools.profile_generate import profile_calls  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval: needs a CUDA card")
    names = argv or list(cs.EVAL_NETS)
    if set(names) - set(cs.EVAL_NETS):
        raise SystemExit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        assets = write_assets(tmp, nets=names)
        for net in names:
            fn = cs.eval_net(net, assets[net], torch.device("cuda"))
            results.append(profile_calls(fn, f"{net} B={cs.EVAL_B} fp32"))
            del fn
            torch.cuda.empty_cache()
    print(json.dumps({"profiles": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
