"""The port's data layer against the JAX package's: the synthetic dataset
item by item (both dynamics, rendering on and off, every partition's index
space), `get_dataset`'s partitions, and the threaded `Loader`'s batches in
order and content (shuffled, the drop_last=False tail, host sharding, the
refill of corrupt samples, `forever()` across epochs). All numpy, equal
exactly."""

import os

import numpy as np
import pytest

from ag2video_tpu.config import Config as JConfig
from ag2video_tpu.data import registry as j_registry
from ag2video_tpu.data.synthetic import SyntheticDataset as JSynthetic
from ag2video_torch.config import Config
from ag2video_torch.data import registry as t_registry
from ag2video_torch.data.synthetic import SyntheticDataset as TSynthetic

PARTITIONS = ("train", "train_graph", "val", "test")
SMALL = dict(dataset="synthetic", image_size=(24, 20), batch_size=3,
             frames_per_action=3, frames_per_action_graph=1, dataset_size=11,
             number_of_objects=4, max_objects=6, max_triplets=8,
             max_actions=3, num_val_samples=4)


def assert_items_equal(got, want):
    """(vids, objs, boxes, triplets, actions, video_id) equal exactly."""
    assert len(got) == len(want) == 6
    for i in (0, 2, 3, 4):
        assert got[i].dtype == want[i].dtype, i
        np.testing.assert_array_equal(got[i], want[i])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert got[5] == want[5]


@pytest.mark.parametrize("render", [True, False], ids=["render", "boxes"])
@pytest.mark.parametrize("dynamics", ["linear", "hard"])
@pytest.mark.parametrize("partition", PARTITIONS)
def test_synthetic_items_match(partition, dynamics, render):
    kw = dict(partition=partition, image_size=(20, 28), frames_per_action=5,
              dataset_size=6, number_of_objects=5, seed=3, max_actions=3,
              dynamics=dynamics, render=render)
    j, t = JSynthetic(**kw), TSynthetic(**kw)
    assert len(t) == len(j) == 6
    assert t.seed == j.seed
    assert t.vocab == j.vocab
    for i in range(len(j)):
        assert_items_equal(t[i], j[i])


def test_synthetic_rejects_unknown_dynamics():
    with pytest.raises(ValueError):
        TSynthetic(dynamics="curvy")


@pytest.mark.parametrize("graph_only", [False, True])
def test_get_dataset_partitions_match(graph_only):
    kw = dict(SMALL, graph_only=graph_only)
    jc, tc = JConfig(**kw), Config(**kw)
    for partition in PARTITIONS:
        j = j_registry.get_dataset("synthetic", partition, jc)
        t = t_registry.get_dataset("synthetic", partition, tc)
        for attr in ("partition", "image_size", "frames", "size",
                     "num_objects", "max_actions", "dynamics", "render",
                     "seed"):
            assert getattr(t, attr) == getattr(j, attr), (partition, attr)
        assert_items_equal(t[1], j[1])


@pytest.mark.parametrize("name", ["cater", "smth_else"])
def test_unported_datasets_raise(name, tmp_path, monkeypatch):
    """Once unported, now built from the shipped split files; without the
    dataset's files an item comes back as the dataset's failure tuple (a
    None tuple for CATER, (False, reason) for Something-Else), which the
    Loader drops."""
    monkeypatch.setenv("CATER_DATA_ROOT", str(tmp_path))
    monkeypatch.setenv("SMTH_DATA_ROOT", str(tmp_path))
    monkeypatch.setenv("SMTH_SPLITS_DIR", os.path.join(
        os.path.dirname(t_registry.__file__), "SomethingElse"))
    ds = t_registry.get_dataset(name, "train", Config(dataset=name))
    assert len(ds) > 1000
    item = ds[0]
    assert item[0] is None or item[0] is False, item


class Corrupt:
    """A dataset whose listed indices fail as CATER's (None tuple),
    Something-Else's ((False, reason)) and a raising loader's do."""

    def __init__(self, ds, bad):
        self.ds, self.bad, self.vocab = ds, bad, ds.vocab

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        kind = self.bad.get(i)
        if kind == "none":
            return (None,) * 6
        if kind == "false":
            return (False, "unreadable")
        if kind == "raise":
            raise OSError("broken file")
        return self.ds[i]


def loader_batches(registry, cfg_cls, kw, corrupt, epochs, **loader_kw):
    cfg = cfg_cls(**SMALL)
    ds = registry.get_dataset("synthetic", "val", cfg)
    if corrupt:
        ds = Corrupt(ds, {2: "none", 5: "false", 7: "raise"})
    loader = registry.Loader(ds, cfg, **kw, **loader_kw)
    out = []
    for e in range(epochs):
        out.append([b for b in loader.epoch(e)])
    return len(loader), out


LOADER_CASES = {
    "shuffled": dict(shuffle=True, seed=2),
    "tail": dict(shuffle=False, drop_last=False),
    "hosts": dict(shuffle=True, drop_last=False, host_index=1, host_count=2),
    "one_thread": dict(shuffle=True, num_threads=1, batch_size=2),
}


@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_match(case, corrupt):
    kw = LOADER_CASES[case]
    n_j, want = loader_batches(j_registry, JConfig, kw, corrupt, 2)
    n_t, got = loader_batches(t_registry, Config, kw, corrupt, 2)
    assert n_t == n_j
    assert [len(e) for e in got] == [len(e) for e in want]
    assert sum(len(e) for e in got) > 0
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            assert g.video_ids == w.video_ids
            for k, v in w.as_dict().items():
                assert g.as_dict()[k].dtype == v.dtype, k
                np.testing.assert_array_equal(g.as_dict()[k], v)


def test_loader_forever_matches():
    """forever() runs the epochs back to back, each reshuffled."""
    out = {}
    for name, registry, cfg_cls in (("jax", j_registry, JConfig),
                                    ("torch", t_registry, Config)):
        cfg = cfg_cls(**SMALL)
        loader = registry.Loader(
            registry.get_dataset("synthetic", "train", cfg), cfg,
            shuffle=True)
        it = loader.forever()
        out[name] = [next(it) for _ in range(3 * len(loader) + 1)]
    ids = [b.video_ids for b in out["torch"]]
    assert ids == [b.video_ids for b in out["jax"]]
    assert ids[:len(ids) // 3] != ids[len(ids) // 3:2 * (len(ids) // 3)]
    for g, w in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(g.imgs, w.imgs)
        np.testing.assert_array_equal(g.boxes, w.boxes)
