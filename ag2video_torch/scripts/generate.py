"""Inference / action-composition CLI (port of scripts/generate.py;
reference scripts/test.py).

    python -m ag2video_torch.scripts.generate --checkpoint output/run1 \
        --output_dir output/results --save_test 1 --save_actions 1

The JAX CLI's flags, plus `--device` (default: the CUDA card, which raises
without one; `cpu` for the CPU). `--checkpoint` is a run directory (with
run_args.json) or an `itr_*` path inside one. Writes, under
`<output_dir>/results_<dataset>/`, `test/<id>.pkl` ({'image', 'box'}) and
`test/<id>.gif` for --save_test, and the action sweep's gifs for
--save_actions. The one difference from the JAX CLI: the session loads
without a batch (`sess.load()`).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

log = logging.getLogger("generate")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="run dir (with run_args.json) or itr_* path")
    p.add_argument("--output_dir", default="output/results")
    p.add_argument("--save_test", type=int, default=1)
    p.add_argument("--save_actions", type=int, default=1)
    p.add_argument("--num_videos", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--use_test", type=int, default=1,
                   help="save_test generates from GT boxes (reference "
                        "test.py --use_test default)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (cpu: the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Render the test split of a run -> the results directory."""
    from ag2video_torch.data.registry import Loader, get_dataset
    from ag2video_torch.inference.generate import GenerationSession

    args = build_parser().parse_args(argv)
    run_dir = args.checkpoint
    if not os.path.isdir(run_dir) or not os.path.exists(
            os.path.join(run_dir, "run_args.json")):
        run_dir = os.path.dirname(args.checkpoint)

    sess = GenerationSession(
        run_dir, checkpoint=args.checkpoint,
        overrides={"batch_size": args.batch_size}, device=args.device).load()
    cfg = sess.cfg

    test_ds = get_dataset(cfg.dataset, "test", cfg)
    loader = Loader(test_ds, cfg, batch_size=args.batch_size, shuffle=False,
                    drop_last=False)

    out_dir = os.path.join(args.output_dir, f"results_{cfg.dataset}")
    n = 0
    for batch in loader.epoch(0):
        if args.save_actions:
            sess.run_action_sweep(batch, out_dir)
        if args.save_test:
            sess.save_test_outputs(batch, out_dir,
                                   use_gt=bool(args.use_test))
        n += len(batch.video_ids)
        if n >= args.num_videos:
            break
    log.info("done; wrote artifacts for %d videos under %s", n, out_dir)
    return out_dir


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    main()
