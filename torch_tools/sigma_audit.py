#!/usr/bin/env python3
"""Audit the spectral-norm estimates stored in a checkpoint of the port
(the twin of tools/sigma_audit.py, for `torch.save` checkpoints).

Under spectral normalisation the applied kernel is W / sigma_hat(W), where
sigma_hat is one power iteration per training step from the stored `u`
(`models.normalization.SpectralWeight`). That is right only while the
iteration keeps up with the kernel's true top singular value: a stale
sigma_hat under-normalises, and the discriminator's Lipschitz bound breaks
silently. For every SpectralWeight of the generator and the discriminator
this compares the stored `sigma` with the exact top singular value
(`torch.linalg.svdvals`) of the matrix the estimate is taken of
(`SpectralWeight.matrix`, flax's view: the kernel reshaped to (-1, out)).

    python3 torch_tools/sigma_audit.py <run_dir_or_itr_path> [--device cpu]

It reads the checkpoint (`itr_<t>/`, or the newest under a run directory)
and the run's run_args.json, builds the networks on the CUDA card (on the
CPU with --device cpu; without a card the default raises) and prints, per
network, the kernel count, the mean and max relative error, the worst
kernel and the five largest errors, then `ALL:`, in the JAX tool's words.
Each kernel is named by its flax path (`.../conv/kernel`), as the JAX tool
names it. `spectral_rows(module)` returns the rows.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ag2video_torch.config import Config  # noqa: E402
from ag2video_torch.models.meta import AG2VideoModel  # noqa: E402
from ag2video_torch.models.normalization import SpectralWeight  # noqa: E402
from ag2video_torch.train import checkpoint as ckpt_lib  # noqa: E402
from ag2video_torch.train.state import make_discriminator  # noqa: E402

Row = Tuple[str, float, float]


def spectral_rows(module: torch.nn.Module) -> List[Row]:
    """(flax path of the kernel, stored sigma, exact top singular value)
    for every SpectralWeight in `module`, the SVD on the module's device in
    float64."""
    rows = []
    for name, m in module.named_modules():
        sw = getattr(m, "spectral", None)
        if not isinstance(sw, SpectralWeight):
            continue
        child = "conv" if hasattr(m, "conv") else "dense"
        with torch.no_grad():
            mat = sw.matrix(getattr(m, child).weight).double()
            sigma_true = float(torch.linalg.svdvals(mat)[0])
        path = "/".join(name.split(".") + [child, "kernel"])
        rows.append((path, float(sw.sigma), sigma_true))
    return rows


def rel_errors(rows: Sequence[Row]) -> List[float]:
    return [abs(h - t) / max(t, 1e-12) for _, h, t in rows]


def report(rows: Sequence[Row], tag: str) -> None:
    """Print the JAX tool's lines for one network."""
    if not rows:
        print(f"{tag}: no spectral state")
        return
    errs = rel_errors(rows)
    worst = int(np.argmax(errs))
    print(f"{tag}: {len(rows)} kernels | rel err mean {np.mean(errs):.2%} "
          f"max {np.max(errs):.2%} | sigma_true max "
          f"{max(t for _, _, t in rows):.3f}")
    print(f"  worst: {rows[worst][0]} sigma_hat {rows[worst][1]:.4f} "
          f"vs true {rows[worst][2]:.4f}")
    for norm, h, t in sorted(rows, key=lambda r: -abs(r[1] - r[2]) / r[2])[:5]:
        print(f"    {norm}: hat {h:.4f} true {t:.4f} "
              f"({abs(h - t) / t:.2%})")


def audit(path: str, device: Optional[str] = None
          ) -> Tuple[List[Row], List[Row]]:
    """The rows of the generator and of the discriminator stored at `path`
    (an itr_<t> directory, or a run directory: its newest checkpoint),
    printed as the JAX tool prints them -> (G rows, D rows)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("sigma_audit: no CUDA card is available; pass "
                           "--device cpu to audit on the CPU")
    itr = ckpt_lib.resolve(path)
    cfg, vocab = Config.load_run_args(os.path.dirname(itr))
    data = ckpt_lib.load_state_file(itr)
    model = AG2VideoModel(cfg, vocab, device=device)
    model.load_state_dict(data["model"], strict=True)
    disc = make_discriminator(cfg, vocab, device)
    disc.load_state_dict(data["disc"], strict=True)
    g, d = spectral_rows(model), spectral_rows(disc)
    report(g, "G")
    report(d, "D")
    errs = rel_errors(g + d)
    print(f"ALL: rel err mean {np.mean(errs):.2%} max {np.max(errs):.2%}")
    return g, d


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a run directory or an itr_<t> path in one")
    p.add_argument("--device", default=None,
                   help="cpu, or a CUDA device (default: the card)")
    args = p.parse_args(argv)
    audit(args.path, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
