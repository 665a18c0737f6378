"""The port's copies of pure-numpy modules of the JAX package, held equal to
their originals on numpy inputs: inference/actions.py (every builder),
data/collate.py, data/transforms.py's normalisation and utils/vis.py's
artifacts; and, by their code, the training run's host-side copies:
data/synthetic.py, the registry's `Loader`, utils/tfevents.py,
utils/logging.py, the `StepTimer`, eval/fid.py, the fidelity labels and
`vis.save_images`
(tests/test_torch_{data,eval}.py run them against the originals), and the
evaluation stack's: eval/fid.py's `cached_features`, eval/prd.py,
eval/action_metrics.py, eval/video_score.py's `load_clip` and
scripts/port_torch_weights.py (tests/test_torch_eval_stack.py runs them
against the originals); utils/graphs.py, the scene-graph algebra
(test_graphs_algebra_matches runs it against the original); the
CATER and Something-Else loaders' data files (byte for byte), constants and
pure functions (tests/test_torch_datasets.py runs the loaders against the
originals)."""

import ast
import os
import pickle

import numpy as np
import pytest

from ag2video_tpu.data.collate import collate as j_collate
from ag2video_tpu.data import transforms as j_transforms
from ag2video_tpu.inference import actions as j_actions
from ag2video_tpu.utils import vis as j_vis
from ag2video_tpu.vocab import get_vocab
from ag2video_torch.data.collate import collate as t_collate
from ag2video_torch.data import transforms as t_transforms
from ag2video_torch.inference import actions as t_actions
from ag2video_torch.utils import vis as t_vis


def _objs(rng, B=2, O=6, n_real=4):
    objs = np.zeros((B, O, 4), np.int32)
    objs[:, :n_real] = rng.randint(1, 3, (B, n_real, 4))
    return objs


BUILDER_CALLS = [
    ("single", lambda a, rng: a.single(2, 3)),
    ("single_obj", lambda a, rng: a.single(1, 4, obj=0, t1=-0.2, t2=0.7,
                                           x_end=0.3, y_end=0.6)),
    ("compose", lambda a, rng: a.compose(a.single(0, 1), a.converge(4, 2))),
    ("converge", lambda a, rng: a.converge(5, 3, target_obj=1)),
    ("converge_before", lambda a, rng: a.converge_before(4, 2)),
    ("converge_after", lambda a, rng: a.converge_after(4, 2)),
    ("swap", lambda a, rng: a.swap(rng.uniform(0, 1, (5, 4)), 0, 3, 2, 4)),
    ("shift_before", lambda a, rng: a.shift_before(a.converge(4, 2))),
    ("shift_after", lambda a, rng: a.shift_after(a.converge(4, 2), 1.5)),
    ("extend_horizon", lambda a, rng: a.extend_horizon(a.converge(4, 2), 3)),
    ("action_rows", lambda a, rng: a.action_rows([[1, 2, 3, 4, 5, 6, 7]])),
    ("real_object_count",
     lambda a, rng: np.asarray(a.real_object_count(_objs(rng)))),
]


@pytest.mark.parametrize("name,call", BUILDER_CALLS,
                         ids=[n for n, _ in BUILDER_CALLS])
def test_action_builders_match(name, call):
    want = call(j_actions, np.random.RandomState(3))
    got = call(t_actions, np.random.RandomState(3))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_cater_execute_set_matches(rng):
    vocab = get_vocab("cater")
    objs = _objs(rng)
    boxes = rng.uniform(0, 1, (2, 3, 6, 4)).astype(np.float32)
    imgs = rng.randn(2, 3, 8, 8, 3).astype(np.float32)
    want = j_actions.cater_execute_set(vocab)
    got = t_actions.cater_execute_set(vocab)
    assert [s["action_name"] for s in got] == \
        [s["action_name"] for s in want] == ["converge", "swap"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["action_func"](objs, imgs, boxes),
                                      w["action_func"](objs, imgs, boxes))
    assert set(t_actions.ACTION_BUILDERS) == set(j_actions.ACTION_BUILDERS)


def _samples(rng, vocab):
    fams = list(vocab["attributes"])
    out = []
    # (O, E, A): in the caps; over the edge caps (truncated); over the
    # object cap (skipped); no actions.
    for k, (O, E, A) in enumerate([(3, 2, 1), (4, 7, 5), (9, 2, 1),
                                   (2, 1, 0)]):
        objs = {f: rng.randint(1, 3, O) for f in fams}
        out.append((rng.randn(3, 8, 8, 3), objs,
                    rng.uniform(0, 1, (3, O, 4)).astype(np.float32),
                    rng.randint(0, 3, (3, E, 3)),
                    rng.uniform(0, 1, (A, 7)).astype(np.float32),
                    f"vid_{k}"))
    return out


def test_collate_matches(rng):
    vocab = get_vocab("cater")
    samples = _samples(rng, vocab)
    want = j_collate(samples, vocab, 6, 4, 3)
    got = t_collate(samples, vocab, 6, 4, 3)
    assert got.video_ids == want.video_ids == ["vid_0", "vid_1", "vid_3"]
    for k, v in want.as_dict().items():
        assert got.as_dict()[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.as_dict()[k], v)


def test_denormalize_matches(rng):
    np.testing.assert_array_equal(t_transforms.IMG_MEAN,
                                  j_transforms.IMG_MEAN)
    np.testing.assert_array_equal(t_transforms.IMG_STD, j_transforms.IMG_STD)
    x = rng.randn(5, 7, 3).astype(np.float32) * 3
    np.testing.assert_array_equal(t_transforms.denormalize(x),
                                  j_transforms.denormalize(x))


def test_plot_vid_and_draw_boxes_match(rng):
    video = rng.randn(3, 16, 20, 3).astype(np.float32)
    boxes = rng.uniform(0, 0.6, (3, 4, 4)).astype(np.float32)
    boxes[:, 0] = [0, 0, 1, 1]        # the whole-image dummy box
    boxes[:, 1, 2] = 0.0              # a degenerate box
    for b in (None, boxes):
        got, want = t_vis.plot_vid(video, b), j_vis.plot_vid(video, b)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        t_vis.draw_boxes(video[0], boxes[0], color=(0.5, 0, 1),
                         skip_dummy=False),
        j_vis.draw_boxes(video[0], boxes[0], color=(0.5, 0, 1),
                         skip_dummy=False))


def test_saved_artifacts_match(rng, tmp_path):
    video = rng.randn(3, 16, 16, 3).astype(np.float32)
    boxes = rng.uniform(0, 0.6, (3, 2, 4)).astype(np.float32)
    files = {}
    for name, vis in (("torch", t_vis), ("jax", j_vis)):
        d = tmp_path / name / "sub"
        files[name] = (vis.save_gif(vis.plot_vid(video), str(d / "a.gif")),
                       vis.save_video_pickle(str(d / "a.pkl"), video, boxes))
    # The pkls are byte for byte the same. The gifs are not: the JAX
    # package's imageio picks a palette per file, the port's encoder
    # (utils/gif.py) has a fixed one. Both hold the same frames at the same
    # size, 250 ms apart, looping; the port's read back as its palette's
    # nearest colours, within gif.MAX_ERROR of the frames, and so of the
    # JAX package's gif, frame by frame, within gif.MAX_ERROR plus the JAX
    # gif's own error (measured: 0, as a 16x16 frame has at most 256
    # colours and imageio gives each frame a palette of its own).
    import imageio.v3 as iio

    from ag2video_torch.utils import gif

    with open(files["torch"][1], "rb") as g, open(files["jax"][1], "rb") as w:
        assert g.read() == w.read()
    frames = np.stack(t_vis.plot_vid(video))
    decoded = {k: iio.imread(v[0], index=None)[..., :3]
               for k, v in files.items()}
    assert decoded["torch"].shape == decoded["jax"].shape == frames.shape
    for k, v in files.items():
        meta = iio.immeta(v[0])
        assert meta["duration"] == 250 and meta["loop"] == 0, (k, meta)
    np.testing.assert_array_equal(decoded["torch"],
                                  gif.quantize_frames(frames))
    assert np.abs(decoded["torch"].astype(int) - frames).max() <= \
        gif.MAX_ERROR
    jax_error = 0
    assert np.abs(decoded["jax"].astype(int) - frames).max() <= jax_error
    assert np.abs(decoded["torch"].astype(int) - decoded["jax"]).max() <= \
        gif.MAX_ERROR + jax_error
    with open(files["torch"][1], "rb") as f:
        got = pickle.load(f)
    np.testing.assert_array_equal(got["image"], video)
    np.testing.assert_array_equal(got["box"], boxes)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _strip_docstrings(node):
    for n in ast.walk(node):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef, ast.Module)) and n.body and \
                isinstance(n.body[0], ast.Expr) and \
                isinstance(n.body[0].value, ast.Constant) and \
                isinstance(n.body[0].value.value, str):
            n.body = n.body[1:] or [ast.Pass()]
    return node


def _code(path, names=None, fixes=()):
    """The module's code (`path` from the repository's root) without
    docstrings and top-level imports (or only the top-level definitions in
    `names`), as AST dumps; the JAX package's name reads as the port's,
    and each (old, new) of `fixes` is applied to the source first."""
    with open(os.path.join(REPO, path)) as f:
        src = f.read().replace("ag2video_tpu", "ag2video_torch")
    for old, new in fixes:
        assert old in src, old
        src = src.replace(old, new)
    tree = _strip_docstrings(ast.parse(src))
    out = []
    for n in tree.body:
        if isinstance(n, (ast.Import, ast.ImportFrom)):
            continue
        if names is not None and getattr(n, "name", None) not in names:
            continue
        out.append(ast.dump(n))
    return out


# (module, top-level names or None for the whole module, source fixes
# applied to the JAX original: the one call the port changed on purpose).
# The module's path is the same under both packages, or a pair (JAX
# original, port copy) from the repository's root.
CODE_COPIES = {
    "synthetic": ("data/synthetic.py", None, ()),
    "loader": ("data/registry.py", ["Loader"], ()),
    "tfevents": ("utils/tfevents.py", None, ()),
    "logging": ("utils/logging.py", None, ()),
    "step_timer": ("utils/profiling.py", ["StepTimer"], ()),
    "fid": ("eval/fid.py", ["compute_statistics", "frechet_distance",
                            "fid_from_features",
                            "inception_score_from_probs"], (
        ("covmean, _ = linalg.sqrtm(sigma1.dot(sigma2), disp=False)",
         "covmean = linalg.sqrtm(sigma1.dot(sigma2))"),)),
    "labels": ("eval/backbone.py", ["presence_labels", "grid_labels",
                                    "load_backbone"], ()),
    "save_images": ("utils/vis.py", ["save_images"], ()),
    "cater": ("data/cater.py", ["project_3d_points", "boxes_from_scene",
                                "scene_actions", "normalize_actions",
                                "choose_window", "extract_triplets",
                                "extract_objs"], ()),
    "smth": ("data/smth.py", ["geometric_predicate", "dedupe_boxes_metadata",
                              "extract_triplets", "extract_actions",
                              "extract_bounding_boxes", "choose_window"], ()),
    "cached_features": ("eval/fid.py", ["cached_features"], ()),
    "prd": ("eval/prd.py", None, ()),
    "action_metrics": ("eval/action_metrics.py", None, ()),
    "load_clip": ("eval/video_score.py", ["load_clip"], ()),
    "port_torch_weights": (("scripts/port_torch_weights.py",
                            "ag2video_torch/scripts/port_torch_weights.py"),
                           None, ()),
    "graphs": ("utils/graphs.py", None, ()),
}


def _methods(tree_nodes):
    """Top-level nodes, with each class replaced by its methods."""
    out = []
    for n in tree_nodes:
        if isinstance(n, ast.ClassDef):
            out.extend(m for m in n.body if isinstance(m, ast.FunctionDef))
        else:
            out.append(n)
    return out


def _defs(path, names, fixes=()):
    """The functions and methods in `names`, as `_code` dumps them."""
    with open(os.path.join(REPO, path)) as f:
        src = f.read().replace("ag2video_tpu", "ag2video_torch")
    for old, new in fixes:
        src = src.replace(old, new)
    tree = _strip_docstrings(ast.parse(src))
    return [ast.dump(n) for n in _methods(tree.body)
            if getattr(n, "name", None) in names]


@pytest.mark.parametrize("name", list(CODE_COPIES))
def test_host_copies_are_the_originals(name):
    path, names, fixes = CODE_COPIES[name]
    original, copy = path if isinstance(path, tuple) else (
        os.path.join("ag2video_tpu", path), os.path.join("ag2video_torch",
                                                         path))
    if name in ("cater", "smth"):
        want = _defs(original, names, fixes)
        got = _defs(copy, names)
    else:
        want = _code(original, names, fixes)
        got = _code(copy, names)
    assert len(want) == len(names or want) > 0
    assert got == want


SPLIT_FILES = ["CATER/train.txt", "CATER/val_split.txt",
               "CATER/test_split.txt", "SomethingElse/train.csv",
               "SomethingElse/val_split.csv", "SomethingElse/test_split.csv"]


@pytest.mark.parametrize("rel", SPLIT_FILES)
def test_split_files_are_byte_copies(rel):
    with open(os.path.join(REPO, "ag2video_tpu", "data", rel), "rb") as f:
        want = f.read()
    with open(os.path.join(REPO, "ag2video_torch", "data", rel), "rb") as f:
        assert f.read() == want
    assert len(want) > 50_000


def test_cater_constants_and_functions_match():
    from ag2video_tpu.data import cater as j_cater
    from ag2video_torch.data import cater as t_cater
    from tests.test_datasets import make_cater_scene

    for k in ("CATER_CAM", "SOURCE_W", "SOURCE_H", "MIN_ACTION_FRAMES"):
        np.testing.assert_array_equal(getattr(t_cater, k),
                                      getattr(j_cater, k))
    assert t_cater.BOX_EXTENTS == j_cater.BOX_EXTENTS
    assert t_cater.CORRUPT_VIDEOS == j_cater.CORRUPT_VIDEOS
    vocab = get_vocab("cater")
    for seed in range(4):
        rng = np.random.RandomState(seed)
        pts = rng.uniform(-3, 3, (9, 3))
        np.testing.assert_array_equal(t_cater.project_3d_points(pts),
                                      j_cater.project_3d_points(pts))
        scene = make_cater_scene(n_objects=3 + seed, n_frames=40,
                                 rng=np.random.RandomState(seed))
        boxes = t_cater.boxes_from_scene(scene)
        np.testing.assert_array_equal(boxes, j_cater.boxes_from_scene(scene))
        acts = t_cater.scene_actions(scene, vocab)
        np.testing.assert_array_equal(acts,
                                      j_cater.scene_actions(scene, vocab))
        for s, e in ((0, 12), (seed * 7, seed * 7 + 20), (30, 39)):
            got = t_cater.normalize_actions(acts, boxes, s, e, vocab)
            want = j_cater.normalize_actions(acts, boxes, s, e, vocab)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_smth_functions_match():
    from ag2video_tpu.data import smth as j_smth
    from ag2video_torch.data import smth as t_smth

    rng = np.random.RandomState(0)
    for _ in range(500):
        a, b = np.sort(rng.uniform(0, 1, (2, 2, 2)), axis=1)
        sbox = np.array([a[0, 0], a[1, 0], a[0, 1], a[1, 1]])
        obox = np.array([b[0, 0], b[1, 0], b[0, 1], b[1, 1]])
        if rng.rand() < 0.2:  # nested boxes
            obox = sbox + np.array([0.01, 0.01, -0.01, -0.01])
        for x, y in ((sbox, obox), (obox, sbox)):
            assert t_smth.geometric_predicate(x, y) == \
                j_smth.geometric_predicate(x, y)
    meta = [{"name": f"{rng.randint(5)}.jpg", "k": i} for i in range(20)]
    assert t_smth.dedupe_boxes_metadata(meta) == \
        j_smth.dedupe_boxes_metadata(meta)


def test_graphs_algebra_matches():
    """The copy's functions on the same triplets give the same arrays,
    `reduce_transitive_edges` from the same RandomState included."""
    from ag2video_tpu.utils import graphs as jg
    from ag2video_torch.utils import graphs as tg

    vocab = get_vocab("cater")
    pred = next(iter(vocab["pred_name_to_idx"].values()))
    chain = [[0, pred, 1], [1, pred, 2], [2, pred, 3], [0, pred, 2],
             [0, pred, 3], [1, pred, 3]]
    for fn, args in (("triplets_to_minimal", ()),
                     ("get_maximal_transitive_triplets", ()),
                     ("get_minimal_and_transitive_triplets", ()),
                     ("get_symmetric_triplets", ()),
                     ("get_edge_antisymmetric_triplets", (vocab,))):
        got, want = (getattr(m, fn)(chain, *args) for m in (tg, jg))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for p_keep in (0.0, 0.5, 1.0):
        got, want = (m.reduce_transitive_edges(
            chain, p_keep, np.random.RandomState(3)) for m in (tg, jg))
        np.testing.assert_array_equal(got, want)
    assert len(tg.reduce_transitive_edges(chain, 0.0)) == 3
    assert len(tg.reduce_transitive_edges(chain, 1.0)) == 6
