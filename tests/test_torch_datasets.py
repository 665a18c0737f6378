"""The port's CATER and Something-Else loaders against the JAX package's, on
the JAX tests' fabricated layouts (tests/test_datasets.py's fixtures): items
equal (CATER clips bit for bit: PNG decode and the host library's resize on
both sides), train items under one seeded window, the datasets through the
`Loader` (a corrupt sample dropped and refilled), `from_config` on the
shipped split files, the label CSVs read without pandas to the rows pandas
keeps, and the clip transforms' other branches."""

import csv as std_csv
import json
import os
import pickle

import numpy as np
import pytest

from ag2video_tpu.config import Config as JConfig
from ag2video_tpu.data import cater as j_cater
from ag2video_tpu.data import registry as j_registry
from ag2video_tpu.data import smth as j_smth
from ag2video_tpu.data import transforms as j_transforms
from ag2video_torch.config import Config
from ag2video_torch.data import cater as t_cater
from ag2video_torch.data import registry as t_registry
from ag2video_torch.data import smth as t_smth
from ag2video_torch.data import transforms as t_transforms

from tests.test_datasets import cater_root, smth_root  # noqa: F401

PARTITIONS = ("train", "train_graph", "val", "test")
REAL_RS = np.random.RandomState


def assert_items_equal(got, want):
    """(vids, objs, boxes, triplets, actions, video_id) equal exactly, or
    the same failure tuple."""
    assert len(got) == len(want)
    if want[0] is None or isinstance(want[0], bool):
        assert got == want
        return
    for i in (0, 2, 3, 4):
        assert got[i].dtype == want[i].dtype, i
        np.testing.assert_array_equal(got[i], want[i])
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        assert got[1][k].dtype == want[1][k].dtype, k
        np.testing.assert_array_equal(got[1][k], want[1][k])
    assert got[5] == want[5]


def cater_pair(root, split, **kw):
    kw = dict(split_file=str(split), data_root=str(root), image_size=(16, 16),
              frames_per_action=4, initial_frames_per_sample=12, nframes=30,
              **kw)
    return t_cater.CATERDataset(**kw), j_cater.CATERDataset(**kw)


@pytest.mark.parametrize("kind", ["val", "test"])
def test_cater_items_match(cater_root, kind):  # noqa: F811
    root, split = cater_root
    t, j = cater_pair(root, split, is_val=True, is_test=kind == "test",
                      seed=3)
    assert t.vid_names == j.vid_names and len(t) == 3
    for i in range(len(t)):
        got, want = t[i], j[i]
        assert got[0].shape == (4, 16, 16, 3)
        assert_items_equal(got, want)


def seeded_windows(monkeypatch, seed):
    """Every unseeded RandomState (the train partition's windows) draws
    from `seed`, on both sides."""
    monkeypatch.setattr(np.random, "RandomState",
                        lambda s=None: REAL_RS(seed if s is None else s))


def test_cater_train_items_match_under_one_seed(cater_root,  # noqa: F811
                                                monkeypatch):
    root, split = cater_root
    t, j = cater_pair(root, split)
    for seed in (0, 5):
        seeded_windows(monkeypatch, seed)
        for i in range(len(t)):
            assert_items_equal(t[i], j[i])
    # the window alone, from one rng on each side
    acts = t_cater.scene_actions(j._scene(j.vid_names[0]), j.vocab)
    for seed in range(4):
        got = t.choose_window(acts, 29, REAL_RS(seed))
        want = j.choose_window(acts, 29, REAL_RS(seed))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def tiny_cfgs(dataset, **kw):
    kw = dict(dataset=dataset, image_size=(16, 16), batch_size=2,
              frames_per_action=2, frames_per_action_graph=1, max_objects=6,
              max_triplets=8, max_actions=4, **kw)
    return Config(**kw), JConfig(**kw)


def loader_batches(registry, cfg, ds, n):
    loader = registry.Loader(ds, cfg, shuffle=False, drop_last=False)
    return [b for _, b in zip(range(n), loader.epoch(0))]


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.video_ids == w.video_ids
        for k, v in w.as_dict().items():
            assert g.as_dict()[k].dtype == v.dtype, k
            np.testing.assert_array_equal(g.as_dict()[k], v)


def test_cater_through_the_loader_drops_a_corrupt_sample(cater_root):  # noqa: F811,E501
    root, split = cater_root
    # the second video loses a frame: its cache no longer holds nframes
    os.remove(root / "videos" / "CATER_new_000001" / "00029.png")
    cfg, jcfg = tiny_cfgs("cater")
    t, j = cater_pair(root, split, is_val=True)
    assert t[1] == (None,) * 6
    got = loader_batches(t_registry, cfg, t, 2)
    want = loader_batches(j_registry, jcfg, j, 2)
    assert_batches_equal(got, want)
    assert got[0].video_ids[1].startswith("CATER_new_000002")


def test_cater_from_config_on_the_shipped_splits(tmp_path, monkeypatch):
    monkeypatch.setenv("CATER_DATA_ROOT", str(tmp_path))
    monkeypatch.delenv("CATER_SPLITS_DIR", raising=False)
    monkeypatch.setenv("CATER_NFRAMES", "77")
    cfg, jcfg = tiny_cfgs("cater", seed=4)
    for partition in PARTITIONS:
        t = t_registry.get_dataset("cater", partition, cfg)
        j = j_registry.get_dataset("cater", partition, jcfg)
        assert isinstance(t, t_cater.CATERDataset)
        assert t.vid_names == j.vid_names and len(t) > 400, partition
        for attr in ("frames_per_action", "initial_frames_per_sample",
                     "is_val", "is_test", "nframes", "seed", "image_size",
                     "resize_or_crop", "no_flip", "data_root"):
            assert getattr(t, attr) == getattr(j, attr), (partition, attr)


def test_cater_cache_all_decodes_every_shard(tmp_path, monkeypatch):
    """`cache_all` calls extract_frames on the worker's shard; the last
    shard takes the remainder (7 videos over 2 workers: 3 + 4)."""
    split = tmp_path / "split.txt"
    split.write_text("".join(f"CATER_new_{k:06}.avi\n" for k in range(7)))
    ds = t_cater.CATERDataset(str(split), str(tmp_path / "root"))
    seen = []
    monkeypatch.setattr(ds, "extract_frames", seen.append)
    ds.cache_all(2, 0)
    ds.cache_all(2, 1)
    assert seen == ds.vid_names and len(seen) == 7


# ------------------------------------------------------------ SmthElse
def smth_pair(root, csv, **kw):
    kw = dict(labels_csv=str(csv), data_root=str(root), image_size=(16, 16),
              frames_per_action=4, initial_frames_per_sample=8, **kw)
    return t_smth.SmthElseDataset(**kw), j_smth.SmthElseDataset(**kw)


@pytest.mark.parametrize("kind", ["val", "test", "train"])
def test_smth_items_match(smth_root, kind, monkeypatch):  # noqa: F811
    root, csv = smth_root
    t, j = smth_pair(root, csv, is_val=kind != "train",
                     is_test=kind == "test", seed=2)
    assert t.vid_names == j.vid_names == [101, 102]
    if kind == "train":
        seeded_windows(monkeypatch, 9)
    for i in range(len(t)):
        got, want = t[i], j[i]
        assert not isinstance(got[0], bool), got
        assert_items_equal(got, want)


def test_smth_through_the_loader_drops_a_corrupt_sample(smth_root):  # noqa: F811,E501
    root, csv = smth_root
    import pandas as pd

    df = pd.read_csv(csv)
    df = pd.concat([df, df.assign(id=[103, 104])])
    df.to_csv(csv, index=False)
    # 103 has no boxes.pkl: (False, reason)
    src = root / "offical_release_boxes" / "boxes_by_video_id"
    os.makedirs(src / "104")
    with open(src / "102" / "boxes.pkl", "rb") as f:
        meta = pickle.load(f)
    with open(src / "104" / "boxes.pkl", "wb") as f:
        pickle.dump(meta, f)
    cfg, jcfg = tiny_cfgs("smth_else")
    t, j = smth_pair(root, csv, is_val=True)
    assert t[2][0] is False and j[2][0] is False
    got = loader_batches(t_registry, cfg, t, 2)
    want = loader_batches(j_registry, jcfg, j, 2)
    assert_batches_equal(got, want)
    ids = [v.split("_")[0] for b in got for v in b.video_ids]
    assert len(ids) == 4 and "103" not in ids and "104" in ids


@pytest.mark.parametrize("mapping", [False, True])
@pytest.mark.parametrize("split", ["train", "val_split", "test_split"])
def test_smth_vid_names_on_the_shipped_csvs(tmp_path, split, mapping):
    csv = os.path.join(os.path.dirname(t_smth.__file__), "SomethingElse",
                       f"{split}.csv")
    if mapping:
        d = tmp_path / "offical_release_boxes"
        d.mkdir()
        with open(d / "objs_mapping.json", "w") as f:
            json.dump({"pen": "pen", "a glass": "glass", "bottle": "bottle",
                       "cloth": "cloth", "calculator": "calculator",
                       "compass": "compass", "book": "book", "paper": "paper",
                       "phone": "phone", "cup": "cup"}, f)
    t = t_smth.SmthElseDataset(csv, str(tmp_path))
    j = j_smth.SmthElseDataset(csv, str(tmp_path))
    assert len(t) == len(j) > (0 if mapping else 500)
    assert t.vid_names == j.vid_names
    assert all(type(v) is int for v in t.vid_names)
    assert t.vocab == j.vocab


def test_read_labels_keeps_the_rows_pandas_keeps(tmp_path):
    """pandas' null tokens (only nulls pass the err filter; 'False' is a
    string in a mixed column), its column types (an integer column with a
    null turns float, a column with text stays text), and placeholders
    that are not list literals."""
    import pandas as pd
    from pandas._libs.parsers import STR_NA_VALUES

    assert t_smth.NA_VALUES == set(STR_NA_VALUES)
    tpl = "Moving [something] up"
    rows = [
        ("1", tpl, "['pen']", "2", ""),
        ("2", tpl, "['pen']", "2", "False"),
        ("3", tpl, "['pen']", "2", "NA"),
        ("4", tpl, "['pen']", "2", "e_frame - s_frame < 4"),
        ("5", tpl, "['pen']", "3", "null"),
        ("6", "Unknown template", "['pen']", "2", ""),
        ("7", tpl, "['book']", "2", "#N/A"),
        ("8", tpl, "pen", "2", "None"),
        ("9", tpl, "", "2", "nan"),
        ("10", tpl, '["pen", "pen"]', "2.0", "<NA>"),
        ("11", "NA", "['pen']", "2", ""),
        ("12", tpl, "['pen']", "2", " NA"),
        ("1", tpl, "['pen']", "2", ""),
    ]
    head = ["", "id", "template", "placeholders", "nr_instances", "err"]
    table = [head] + [[str(k), *r] for k, r in enumerate(rows)]
    variants = {
        "ints": table,
        # a null id: the column turns float, and its names with it
        "null id": table + [["99", "", tpl, "['pen']", "2", ""]],
        # a text cell in nr_instances: the column stays text, nothing matches
        "text count": table + [["98", "13", tpl, "['pen']", "two", ""]],
    }
    d = tmp_path / "offical_release_boxes"
    d.mkdir()
    with open(d / "objs_mapping.json", "w") as f:
        json.dump({"pen": "pen"}, f)
    for name, body in variants.items():
        csv = tmp_path / f"{name}.csv"
        with open(csv, "w", newline="") as f:
            std_csv.writer(f).writerows(body)
        df = pd.read_csv(csv)
        header, got = t_smth.read_labels(str(csv))
        assert header == [""] + list(df.columns[1:])
        for col in ("id", "nr_instances", "template", "err"):
            for g, w in zip([r[col] for r in got], df[col]):
                assert t_smth.isnull(g) == bool(pd.isnull(w)), (name, col)
                if not pd.isnull(w):
                    assert g == w and type(g) is type(w.item() if hasattr(
                        w, "item") else w), (name, col, g, w)
        for root in (tmp_path, tmp_path / "no_mapping"):
            t = t_smth.SmthElseDataset(str(csv), str(root))
            if name == "text count" and root == tmp_path:
                # No row reaches the placeholders filter; the JAX loader
                # then fails on the empty frame its row-wise apply returns.
                assert t.vid_names == []
                with pytest.raises(KeyError):
                    j_smth.SmthElseDataset(str(csv), str(root))
                continue
            j = j_smth.SmthElseDataset(str(csv), str(root))
            # as they enter paths and names (a null id is nan on both sides)
            assert [str(v) for v in t.vid_names] == \
                [str(v) for v in j.vid_names], (name, root)
            assert [type(v) for v in t.vid_names] == \
                [type(v.item() if hasattr(v, "item") else v)
                 for v in j.vid_names]
    assert t_smth.SmthElseDataset(str(tmp_path / "ints.csv"),
                                  str(tmp_path)).vid_names == [1, 3, 10, 1]


# ------------------------------------------------------- clip transforms
@pytest.mark.parametrize("mode,train,no_flip", [
    ("resize", False, True), ("resize", True, True), ("resize", True, False),
    ("crop", False, True), ("crop", True, False), ("scale", True, True)])
def test_clip_transform_matches(mode, train, no_flip):
    """Every branch on uint8 arrays equals the JAX transform on the same
    frames as PIL images; the default branch bit for bit through the host
    library."""
    from PIL import Image

    rng = REAL_RS(1)
    frames = [rng.randint(0, 256, (30, 41, 3)).astype(np.uint8)
              for _ in range(3)]
    for seed in range(3):
        got = t_transforms.clip_transform(frames, (12, 20), mode, train,
                                          no_flip, REAL_RS(seed))
        want = j_transforms.clip_transform(
            [Image.fromarray(f) for f in frames], (12, 20), mode, train,
            no_flip, REAL_RS(seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
