"""The port's evaluation and telemetry layer against the JAX package's: box
transforms and IoU statistics, the Frechet distance and Inception-Score
math, the synthetic fidelity backbone on the committed asset
(assets/synthetic_backbone.npz) with its labels, resize and scorer, and
the metrics stream (TensorBoard event bytes and metrics.jsonl records)."""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ag2video_tpu.eval import backbone as jb
from ag2video_tpu.eval import fid as j_fid
from ag2video_tpu.ops import boxes as j_boxes
from ag2video_tpu.ops import metrics as j_metrics
from ag2video_tpu.utils import logging as j_logging
from ag2video_tpu.utils import profiling as j_profiling
from ag2video_tpu.utils import tfevents as j_tfevents
from ag2video_torch.eval import backbone as tb
from ag2video_torch.eval import fid as t_fid
from ag2video_torch.ops import boxes as t_boxes
from ag2video_torch.ops import metrics as t_metrics
from ag2video_torch.utils import logging as t_logging
from ag2video_torch.utils import profiling as t_profiling
from ag2video_torch.utils import tfevents as t_tfevents

torch.set_num_threads(2)

# fp32 box arithmetic in another op order: one ulp of values <= 2.
BOX_ATOL = 1e-6
# The backbone's four convs and GroupNorms in fp32, XLA's CPU convs against
# PyTorch's: |diff| <= 1e-5 * max|JAX output| + 1e-6 (observed 2.8e-6 of
# the largest logit, 23.5, on the committed weights).
BACKBONE_RTOL = 1e-5
# _resize64 off the integer path: torch's antialiased bilinear and
# jax.image.resize's bilinear both weight by the triangle kernel scaled to
# the downsampling factor; they agree to fp32 rounding (observed 4.8e-7 on
# unit-variance inputs).
RESIZE_ATOL = 2e-6


def box_pairs(rng, n=64):
    """xywh pairs with degenerate cases: zero width, zero height, disjoint,
    identical, nested, touching edges."""
    p = rng.uniform(0, 0.7, (2, 3, n, 4)).astype(np.float32)
    g = rng.uniform(0, 0.7, (2, 3, n, 4)).astype(np.float32)
    p[0, 0, 0, 2] = 0.0
    g[0, 0, 1, 3] = 0.0
    p[0, 0, 2], g[0, 0, 2] = [0.0, 0.0, 0.1, 0.1], [0.5, 0.5, 0.2, 0.2]
    p[0, 0, 3] = g[0, 0, 3]
    p[0, 0, 4], g[0, 0, 4] = [0.1, 0.1, 0.6, 0.6], [0.2, 0.2, 0.1, 0.1]
    p[0, 0, 5], g[0, 0, 5] = [0.0, 0.0, 0.2, 0.2], [0.2, 0.0, 0.2, 0.2]
    p[0, 0, 6] = g[0, 0, 6] = 0.0
    return p, g


@pytest.mark.parametrize("fn", ["xywh_to_xyxy", "centers_to_extents",
                                "extents_to_centers"])
def test_box_transforms_match(rng, fn):
    b = rng.uniform(-0.5, 1.5, (3, 5, 4)).astype(np.float32)
    want = np.asarray(getattr(j_boxes, fn)(jnp.asarray(b)))
    got = getattr(t_boxes, fn)(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)


def test_box_deltas_match(rng):
    """apply / invert_box_transform and remove_small_boxes_mask; the
    deltas of `apply` inverted give the deltas back."""
    anchors = np.concatenate([rng.uniform(0.0, 1.0, (3, 5, 2)),
                              rng.uniform(0.05, 0.6, (3, 5, 2))],
                             -1).astype(np.float32)
    deltas = rng.uniform(-0.5, 0.5, (3, 5, 4)).astype(np.float32)
    boxes = np.array(j_boxes.apply_box_transform(jnp.asarray(anchors),
                                                 jnp.asarray(deltas)))
    got = t_boxes.apply_box_transform(torch.from_numpy(anchors),
                                      torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, boxes, rtol=1e-6, atol=BOX_ATOL)
    want = np.asarray(j_boxes.invert_box_transform(jnp.asarray(anchors),
                                                   jnp.asarray(boxes)))
    got = t_boxes.invert_box_transform(torch.from_numpy(anchors),
                                       torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=BOX_ATOL)
    np.testing.assert_allclose(got, deltas, rtol=1e-5, atol=1e-6)
    boxes[0, 1, 2] = 0.0
    np.testing.assert_array_equal(
        t_boxes.remove_small_boxes_mask(torch.from_numpy(boxes), 0.1).numpy(),
        np.asarray(j_boxes.remove_small_boxes_mask(jnp.asarray(boxes), 0.1)))


def test_iou_xywh_matches(rng):
    p, g = box_pairs(rng)
    want = np.asarray(j_metrics.iou_xywh(jnp.asarray(p), jnp.asarray(g)))
    got = t_metrics.iou_xywh(torch.from_numpy(p), torch.from_numpy(g)).numpy()
    assert got.shape == want.shape == p.shape[:-1]
    # Two empty boxes have no union: NaN on both sides, nowhere else.
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() == 1 and np.isnan(got[0, 0, 6])
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)
    assert got[0, 0, 2] == 0.0 and abs(got[0, 0, 3] - 1.0) < 1e-6


@pytest.mark.parametrize("mask", ["none", "random", "empty"])
def test_iou_stats_match(rng, mask):
    p, g = box_pairs(rng)
    m = {"none": None,
         "random": (rng.rand(*p.shape[:-1]) > 0.3).astype(np.float32),
         "empty": np.zeros(p.shape[:-1], np.float32)}[mask]
    want = j_metrics.iou_stats(jnp.asarray(p), jnp.asarray(g),
                               None if m is None else jnp.asarray(m))
    got = t_metrics.iou_stats(torch.from_numpy(p), torch.from_numpy(g),
                              None if m is None else torch.from_numpy(m > 0))
    for w, t in zip(want, got):
        assert t.dim() == 0
        np.testing.assert_allclose(float(t), float(w), rtol=1e-6, atol=1e-5)
    # The counts are exact.
    for w, t in zip(want[1:], got[1:]):
        assert float(t) == float(w)


def test_iou_masks_match(rng):
    a = rng.rand(4, 16, 16) > 0.5
    b = rng.rand(4, 16, 16) > 0.4
    want = float(j_metrics.iou_masks(jnp.asarray(a), jnp.asarray(b)))
    got = float(t_metrics.iou_masks(torch.from_numpy(a), torch.from_numpy(b)))
    assert np.isclose(got, want, rtol=1e-6)


def test_fid_math_matches(rng):
    f1 = rng.randn(40, 6)
    f2 = rng.randn(50, 6) * 1.3 + 0.4
    for jf, tf in ((j_fid.compute_statistics(f1), t_fid.compute_statistics(f1)),):
        for a, b in zip(jf, tf):
            np.testing.assert_array_equal(b, a)
    assert t_fid.fid_from_features(f1, f2) == j_fid.fid_from_features(f1, f2)
    assert t_fid.fid_from_features(f1, f1) == pytest.approx(0.0, abs=1e-6)
    m1, s1 = j_fid.compute_statistics(f1)
    m2, s2 = j_fid.compute_statistics(f2)
    assert t_fid.frechet_distance(m1, s1, m2, s2) == \
        j_fid.frechet_distance(m1, s1, m2, s2)
    probs = rng.dirichlet(np.ones(10), 23)
    assert t_fid.inception_score_from_probs(probs, 5) == \
        j_fid.inception_score_from_probs(probs, 5)


def test_labels_match(rng):
    shape = rng.randint(0, 4, (5, 7))
    color = rng.randint(1, 7, (5, 7))
    objs = {"shape": shape, "color": color}
    np.testing.assert_array_equal(tb.presence_labels(objs),
                                  jb.presence_labels(objs))
    boxes = rng.uniform(-0.1, 0.9, (5, 3, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(tb.grid_labels(boxes, objs),
                                  jb.grid_labels(boxes, objs))
    assert (tb.N_PRESENCE, tb.GRID, tb.INPUT_SIZE) == \
        (jb.N_PRESENCE, jb.GRID, jb.INPUT_SIZE)


@pytest.mark.parametrize("size", [(64, 64), (256, 256), (80, 80),
                                  (100, 72)])
def test_resize64_matches(rng, size):
    x = rng.randn(3, *size, 3).astype(np.float32)
    want = np.asarray(jb._resize64(jnp.asarray(x)))
    got = tb._resize64(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 64, 64, 3)
    if size[0] % 64 == 0 and size[1] % 64 == 0:  # the area path
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


@pytest.fixture(scope="module")
def asset():
    loaded = tb.load_backbone()
    assert loaded is not None, "assets/synthetic_backbone.npz is committed"
    return loaded


def test_load_backbone_reads_the_asset(asset):
    params, meta = asset
    j_params, j_meta = jb.load_backbone()
    assert meta == j_meta
    assert tb.DEFAULT_WEIGHTS == jb.DEFAULT_WEIGHTS
    assert tb.load_backbone(os.path.join("no", "such.npz")) is None
    model = tb.backbone_from_params(params)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.size(v) for v in
                    _leaves(j_params["params"]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("size", [64, 256])
def test_backbone_matches_on_the_asset(asset, size):
    """Features, presence and grid logits on real synthetic frames (the
    val pass's inputs) and on noise, at the backbone's 64^2 and through the
    area resize from 256^2."""
    from ag2video_torch.data.synthetic import SyntheticDataset

    params, _ = asset
    ds = SyntheticDataset("val", image_size=(size, size), frames_per_action=2,
                          dataset_size=2, number_of_objects=4)
    frames = np.concatenate([ds[0][0], ds[1][0],
                             np.random.RandomState(1).randn(
                                 2, size, size, 3).astype(np.float32)])
    want = jb.SyntheticEvalBackbone().apply(params,
                                            jb._resize64(jnp.asarray(frames)))
    model = tb.backbone_from_params(params)
    with torch.no_grad():
        got = model(tb._resize64(torch.from_numpy(frames)))
    for name, w, g in zip(("features", "presence", "grid"), want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        bound = BACKBONE_RTOL * float(np.abs(w).max()) + 1e-6
        assert float(np.abs(g.numpy() - w).max()) <= bound, name


def test_fidelity_score_matches(asset, rng):
    params, _ = asset
    ds_size = 256
    fake = rng.randn(6, ds_size, ds_size, 3).astype(np.float32) * 0.5
    real = rng.randn(5, ds_size, ds_size, 3).astype(np.float32)
    pres = (rng.rand(6, tb.N_PRESENCE) > 0.8).astype(np.float32)
    j = jb.FidelityScore(params)
    t = tb.FidelityScore(params, device="cpu")
    for s, conv in ((j, jnp.asarray), (t, torch.from_numpy)):
        s.add_fake(conv(fake[:4]), presence=pres[:4])
        s.add_fake(conv(fake[4:]), presence=pres[4:])
        s.add_real(conv(real))
    want, got = j.compute(), t.compute()
    assert set(got) == set(want) == {"fidelity_fid",
                                     "fidelity_presence_acc"}
    assert got["fidelity_presence_acc"] == want["fidelity_presence_acc"]
    assert got["fidelity_fid"] == pytest.approx(want["fidelity_fid"],
                                                rel=1e-4)
    t.clean()
    assert t.compute() == {}


def test_fidelity_score_needs_a_card_by_default(asset):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.FidelityScore(asset[0])


SCALARS = [(0, {"G/total_loss": 1.5, "D/total_img_loss": np.float32(0.25)}),
           (3, {"use_gt/fidelity_fid": 12.75, "no_use_gt/avg_iou":
                np.float64(0.1)}),
           (7, {})]


def test_event_file_and_metrics_stream_match(tmp_path, monkeypatch):
    """Both writers, the same clock: the same file name and bytes of the
    TensorBoard event file, and the same metrics.jsonl text."""
    monkeypatch.setattr("time.time", lambda: 1700000000.25)
    out = {}
    for name, mod in (("jax", j_logging), ("torch", t_logging)):
        d = tmp_path / name
        w = mod.MetricsWriter(str(d))
        for step, scalars in SCALARS:
            w.write(step, scalars)
        w.close()
        files = sorted(os.listdir(d))
        out[name] = {f.split(".")[0] if f.startswith("events") else f:
                     (f, (d / f).read_bytes()) for f in files}
    assert out["torch"].keys() == out["jax"].keys() == {"events",
                                                       "metrics.jsonl"}
    for k in out["jax"]:
        assert out["torch"][k] == out["jax"][k], k
    assert out["torch"]["metrics.jsonl"][1].count(b"\n") == 3


def test_event_encoding_matches():
    for step, scalars in SCALARS[:2]:
        assert t_tfevents.encode_scalar_event(step, scalars, 5.5) == \
            j_tfevents.encode_scalar_event(step, scalars, 5.5)
    assert t_tfevents.frame_record(b"abc") == j_tfevents.frame_record(b"abc")
    assert t_tfevents.crc32c(b"123456789") == 0xE3069283


def test_step_timer_matches(monkeypatch):
    ticks = [0.0, 0.5, 0.75, 1.5, 1.625]
    stats = []
    for mod in (j_profiling, t_profiling):
        it = iter(ticks)
        monkeypatch.setattr("time.perf_counter", lambda: next(it))
        timer = mod.StepTimer(window=3)
        for _ in ticks:
            timer.tick()
        stats.append((timer.stats(), timer.mean_ms, timer.p50_ms))
    assert stats[0] == stats[1]
    # The window keeps the last 3 of the 4 intervals: 250, 750, 125 ms.
    assert stats[1][0]["step_ms_p50"] == 250.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with t_profiling.trace(str(tmp_path / "profile")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    files = os.listdir(tmp_path / "profile")
    assert len(files) == 1 and files[0].endswith(".json")
