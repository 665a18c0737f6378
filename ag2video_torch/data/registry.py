"""Dataset registry and loader (port of ag2video_tpu/data/registry.py; the
`Loader` is a copy, held equal to it by tests/test_torch_data.py; pure
numpy).

Four partitions with the reference's windowing scheme
(data/dataset_params.py:107-195): `train` (short clips), `train_graph` (4x
longer clips for the graph-only loss), `val`, `test`. A threaded prefetch
loader yields fixed-shape numpy `Batch`es, sharded per host by index
stride; the trainer uploads them to the device (`Trainer._batch`).

`cater` and `smth_else` read their datasets' files from the roots their
environment variables name (data/cater.py, data/smth.py); the repository
ships their split files only.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ag2video_torch.config import Config
from ag2video_torch.data.collate import Batch, collate
from ag2video_torch.data.synthetic import SyntheticDataset

log = logging.getLogger(__name__)


def get_dataset(name: str, partition: str, cfg: Config):
    """Build a dataset for `partition` in
    {train, train_graph, val, test}."""
    if name == "synthetic":
        frames = {
            "train": cfg.frames_per_action,
            "train_graph": 4 * cfg.frames_per_action_graph,
            "val": cfg.frames_per_action,
            "test": cfg.frames_per_action,
        }[partition]
        size = {
            "train": cfg.dataset_size,
            "train_graph": cfg.dataset_size,
            "val": max(cfg.num_val_samples, 64),
            "test": max(cfg.num_val_samples, 64),
        }[partition]
        return SyntheticDataset(
            partition=partition,
            image_size=cfg.image_size,
            frames_per_action=frames,
            dataset_size=size,
            number_of_objects=min(cfg.number_of_objects, cfg.max_objects - 1),
            seed=cfg.seed,
            max_actions=cfg.max_actions,
            dynamics=cfg.synthetic_dynamics,
            # The graph loss reads boxes, never pixels (meta.py returns
            # before the generator), so the train_graph partition never
            # renders; the train partition renders unless graph_only.
            # val/test always render so check_model artifacts are real.
            render=not (partition == "train_graph"
                        or (cfg.graph_only and partition == "train")),
        )
    if name == "cater":
        from ag2video_torch.data.cater import CATERDataset
        return CATERDataset.from_config(partition, cfg)
    if name == "smth_else":
        from ag2video_torch.data.smth import SmthElseDataset
        return SmthElseDataset.from_config(partition, cfg)
    raise ValueError(f"Unknown dataset {name!r}")


class Loader:
    """Threaded prefetching batch loader over an indexable dataset.

    Per-host sharding: each process sees a disjoint 1/num_hosts slice
    (index stride), in place of the reference's DistributedSampler.
    """

    def __init__(
        self,
        dataset,
        cfg: Config,
        batch_size: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_threads: int = 2,
        host_index: int = 0,
        host_count: int = 1,
    ):
        self.ds = dataset
        self.cfg = cfg
        self.batch_size = batch_size or cfg.batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.indices = np.arange(host_index, len(dataset), host_count)

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.indices) // self.batch_size
        return int(np.ceil(len(self.indices) / self.batch_size))

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        idx = self.indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        n = len(idx) - (len(idx) % self.batch_size if self.drop_last else 0)
        batches = [idx[i:i + self.batch_size] for i in range(0, n, self.batch_size)]
        if not batches:
            return

        q: "queue.Queue" = queue.Queue(maxsize=4)
        stop = threading.Event()

        def fetch(i: int):
            """One sample, or None if corrupt: CATER returns None tuples
            (cater.py:387), SmthElse returns (False, reason)
            (smth.py:299-358, collate filter dataset_params.py:30)."""
            try:
                s = self.ds[int(i)]
            except Exception as e:
                log.warning("sample %d failed: %s", i, e)
                return None
            if s[0] is None or isinstance(s[0], bool):
                return None
            return s

        def worker(worker_id: int):
            # try/finally: the sentinel MUST go out even on a worker crash,
            # and every batch index must be acknowledged (with None when it
            # produced nothing) or the reordering loop deadlocks.
            try:
                for bi, batch_idx in enumerate(batches):
                    if bi % self.num_threads != worker_id:
                        continue
                    if stop.is_set():
                        return
                    samples = [s for s in (fetch(i) for i in batch_idx)
                               if s is not None]
                    # Refill to the static batch size: corrupt samples are
                    # replaced by neighboring indices so shapes stay fixed
                    # (a shrunken batch means an XLA recompile and breaks
                    # data-axis divisibility under a mesh). Probing walks
                    # this loader's OWN epoch order (idx) — never raw
                    # dataset indices — so per-host shards stay disjoint.
                    # Refill only up to the batch's INTENDED size
                    # (len(batch_idx)): a naturally short tail batch
                    # (drop_last=False, zero corrupt samples) needs no
                    # refill and is yielded short — never padded with
                    # wrap-around duplicates that would double-count
                    # samples in val/test metrics.
                    want = len(batch_idx)
                    probe = (bi + 1) * self.batch_size
                    attempts = 0
                    while samples and len(samples) < want \
                            and attempts < 4 * self.batch_size:
                        s = fetch(idx[probe % len(idx)])
                        if s is not None:
                            samples.append(s)
                        probe += 1
                        attempts += 1
                    try:
                        out = self._collate(samples) if len(
                            samples) == want else None
                        # collate may itself drop cap-violating samples;
                        # only intended-size batches keep shapes static.
                        if out is not None and \
                                out.imgs.shape[0] != want:
                            log.warning("batch %d shrank in collate; "
                                        "dropping", bi)
                            out = None
                    except Exception as e:
                        log.warning("collate failed for batch %d: %s", bi, e)
                        out = None
                    q.put((bi, out))
            finally:
                q.put((None, None))

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_threads)]
        for t in threads:
            t.start()

        # Re-order by batch index to keep determinism despite threading.
        # Every batch index is acknowledged (value None = dropped batch), so
        # next_bi always advances and the loop cannot deadlock.
        pending: Dict[int, Optional[Batch]] = {}
        done_workers = 0
        next_bi = 0
        try:
            while done_workers < self.num_threads or pending:
                while next_bi in pending:
                    batch = pending.pop(next_bi)
                    next_bi += 1
                    if batch is not None:
                        yield batch
                if done_workers == self.num_threads:
                    break
                bi, batch = q.get()
                if bi is None:
                    done_workers += 1
                    continue
                pending[bi] = batch
        finally:
            stop.set()

    def _collate(self, samples) -> Batch:
        return collate(
            samples, self.ds.vocab, self.cfg.max_objects,
            self.cfg.max_triplets, self.cfg.max_actions)

    def forever(self) -> Iterator[Batch]:
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1
