"""Training CLI (port of scripts/train.py; reference scripts/train.py).

    python -m ag2video_torch.scripts.train --dataset synthetic \
        --image_size 64,64 --num_iterations 1000 --output_dir output/run1

Flags are generated from the port's `Config` (names as the reference's,
data/args.py), plus `--device` (default: the CUDA card, which raises
without one; `cpu` for the CPU). The run directory is self-describing:
`run_args.json` (+ vocab), `metrics.jsonl` and a TensorBoard event file,
and `itr_<t>/` checkpoints, which `inference.GenerationSession(output_dir)`
renders. `--restore_checkpoint 1` resumes from `--checkpoint_name` if it
is a path, else from the newest `itr_*` under `--output_dir`.

`--cache_data 1` pre-warms the dataset's frame cache (CATER: the PNG cache
decoded from the videos) over shard `--cache_worker_id` of
`--cache_workers` and returns without training.

Every training mode of the Config runs: teacher forcing or `--bp_prev 1`
(the autoregressive loop), either flow decoder (`--flow_deconv`), fp32 or
`--param_dtype bfloat16` parameters (fp32 masters in the Adams). Not here:
`--debug_nans` (a JAX flag, not to port) and a model axis
(`--mesh_model` > 1 raises under data parallel).

Data parallel, one process per card:

    torchrun --nproc_per_node N -m ag2video_torch.scripts.train ...

(`--device cpu` runs the ranks on the CPU over gloo; on the cards they
use NCCL). `parallel.init_distributed` joins the group from torchrun's
variables before the first CUDA call; a process group that the caller
already initialised is used as it is. Each rank reads its own slice of
every split (`Loader(host_index=rank, host_count=world)`) and feeds
`--batch_size` clips, so the global batch is batch_size x world, as under
the JAX package's multi-host contract; the trainer trains over the data
axis (`Trainer(mesh=...)`). The metrics stream, `run_args.json`,
checkpoints and videos are rank 0's.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import Optional, Sequence

log = logging.getLogger("train")


def int_tuple(s):
    return tuple(int(i) for i in s.split(","))


def bool_flag(s):
    if s in ("1", "true", "True"):
        return True
    if s in ("0", "false", "False"):
        return False
    raise ValueError(f'Invalid bool flag "{s}"')


def build_parser() -> argparse.ArgumentParser:
    """Flags from the Config dataclass, plus the cache pre-warmer's and
    --device."""
    from ag2video_torch.config import Config

    p = argparse.ArgumentParser(description=__doc__)
    for f in dataclasses.fields(Config):
        name = f"--{f.name}"
        if f.type in ("bool", bool):
            p.add_argument(name, type=bool_flag, default=f.default)
        elif f.name == "image_size":
            p.add_argument(name, type=int_tuple, default=f.default)
        elif f.type in ("int", int):
            p.add_argument(name, type=int, default=f.default)
        elif f.type in ("float", float):
            p.add_argument(name, type=float, default=f.default)
        else:
            p.add_argument(name, type=str, default=f.default)
    # Cache pre-warmer flags (reference --cache_data/--num_workers/
    # --worker_id, data/args.py:66-68).
    p.add_argument("--cache_data", type=int, default=0)
    p.add_argument("--cache_workers", type=int, default=1)
    p.add_argument("--cache_worker_id", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card (cpu: the CPU)")
    return p


def main(argv: Optional[Sequence[str]] = None):
    """Parse `argv`, join the process group torchrun describes (if any),
    build the data, the trainer and the run directory, and train -> the
    Trainer (None after --cache_data). A group joined here is left on the
    way out."""
    import torch.distributed as dist

    from ag2video_torch.config import Config
    from ag2video_torch.parallel.mesh import init_distributed

    args = build_parser().parse_args(argv)
    cfg = Config.from_dict(vars(args))
    # Before the first CUDA call; a no-op without torchrun's variables.
    device = init_distributed(args.device)
    try:
        return _train(args, cfg, device or args.device)
    finally:
        if device is not None:
            dist.destroy_process_group()


def _train(args, cfg, device):
    from ag2video_torch.data.registry import Loader, get_dataset
    from ag2video_torch.parallel.mesh import (make_mesh, process_count,
                                              process_index)
    from ag2video_torch.train.checkpoint import latest_checkpoint
    from ag2video_torch.train.state import param_count
    from ag2video_torch.train.trainer import Trainer
    from ag2video_torch.utils.logging import MetricsWriter

    train_ds = get_dataset(cfg.dataset, "train", cfg)
    # Dataset cache pre-warmer: decode a 1/cache_workers shard, then return
    # (reference --cache_data mode, scripts/train.py:328-343).
    if args.cache_data:
        if hasattr(train_ds, "cache_all"):
            train_ds.cache_all(args.cache_workers, args.cache_worker_id)
        return None
    graph_ds = get_dataset(cfg.dataset, "train_graph", cfg)
    val_ds = get_dataset(cfg.dataset, "val", cfg)
    vocab = train_ds.vocab
    cfg = cfg.derive(vocab)  # reference init_args (data/args.py:184-207)

    rank, world = process_index(), process_count()
    lkw = dict(host_index=rank, host_count=world)
    train_loader = Loader(train_ds, cfg, shuffle=True, **lkw)
    graph_loader = Loader(graph_ds, cfg, shuffle=True, **lkw)
    val_loader = Loader(val_ds, cfg, shuffle=cfg.shuffle_val, drop_last=False,
                        **lkw)

    mesh = None
    if world > 1:
        # The JAX CLI's check (the reference's GPU-divisibility assert,
        # data/args.py:203-205), with the ranks for its devices.
        if cfg.batch_size % world:
            raise ValueError(f"batch_size {cfg.batch_size} must divide over "
                             f"the {world} ranks")
        mesh = make_mesh(model=cfg.mesh_model)
        log.info("data axis: rank %d of %d", mesh.rank, mesh.world)

    trainer = Trainer(cfg, vocab, device=device, mesh=mesh)
    trainer.init(next(train_loader.epoch(0)))
    log.info("G params: %.2fM  D params: %.2fM",
             param_count(trainer.state.model) / 1e6,
             param_count(trainer.state.disc) / 1e6)

    if cfg.restore_checkpoint:
        path = cfg.checkpoint_name
        if not os.path.exists(path):
            path = latest_checkpoint(cfg.output_dir)
            if path is None:
                raise FileNotFoundError(
                    f"no checkpoint at {cfg.checkpoint_name!r} and no itr_* "
                    f"under {cfg.output_dir!r}")
        trainer.restore_checkpoint(path)
        log.info("resumed from %s at step %d", path, trainer.state.step)

    # Host-side writes are rank 0's (the JAX CLI's is_main).
    is_main = rank == 0
    writer = MetricsWriter(cfg.output_dir) if cfg.output_dir and is_main \
        else None
    if cfg.output_dir and is_main:
        cfg.save_run_args(cfg.output_dir, vocab)
    try:
        trainer.fit(train_loader, graph_loader, val_loader,
                    metrics_writer=writer, timing=cfg.timing)
    finally:
        if writer is not None:
            writer.close()
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    main()
