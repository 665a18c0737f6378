#!/usr/bin/env python3
"""Export a JAX run's checkpoint as weights the PyTorch port loads.

    python3 torch_tools/export_run_weights.py <run_dir>/itr_<t>
    python3 torch_tools/export_run_weights.py <run_dir>      # newest itr_*

Runs where the JAX package and orbax run (the card machine has neither).
The checkpoint is restored as the JAX `GenerationSession.load` restores it:
`create_train_state` from the run's `run_args.json` builds the target, then
`restore_checkpoint(..., for_inference=True)`. The model's `params`,
`batch_stats` and `spectral` collections are written, as float32, to
`<run_dir>/itr_<t>.npz` with keys `<collection>/<path/with/slashes>`
(`ag2video_torch.flax_npz`, numpy only: torch is not needed here); the
discriminator, VGG and optimizer states are not exported. Then, on the
card:

    GenerationSession(run_dir).load()   # ag2video_torch.inference
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

from __graft_entry__ import _make_inputs  # noqa: E402
from ag2video_tpu.config import Config  # noqa: E402
from ag2video_tpu.train.checkpoint import (  # noqa: E402
    latest_checkpoint, restore_checkpoint)
from ag2video_tpu.train.state import create_train_state  # noqa: E402
from ag2video_torch.flax_npz import flatten_variables  # noqa: E402


def export(checkpoint: str) -> str:
    """Restore `checkpoint` (an itr_<t> directory, or a run directory whose
    newest one is taken) and write `<checkpoint>.npz`; returns its path."""
    checkpoint = os.path.abspath(checkpoint)
    if not os.path.basename(checkpoint).startswith("itr_"):
        found = latest_checkpoint(checkpoint)
        if found is None:
            raise FileNotFoundError(f"no itr_* checkpoints under {checkpoint}")
        checkpoint = found
    cfg, vocab = Config.load_run_args(os.path.dirname(checkpoint))
    if vocab is None:
        raise ValueError("run_args.json must embed the vocab")
    # Parameter shapes do not depend on the batch: one sample of the run's
    # shapes builds the target.
    sample = _make_inputs(cfg, vocab, B=1, T=cfg.frames_per_action)
    state, _, _, _ = create_train_state(cfg, vocab, jax.random.PRNGKey(0),
                                        sample)
    state = restore_checkpoint(checkpoint, state, for_inference=True,
                               to_device=False)
    variables = {"params": state.params, **state.model_state}
    out = checkpoint + ".npz"
    np.savez(out, **flatten_variables(jax.device_get(variables)))
    return out


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(export(argv[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
