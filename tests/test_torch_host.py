"""The port's host library (ag2video_torch/csrc/host.cpp through
data/native.py) and its PNG reader (data/png.py): the resize + normalize and
the box padding equal the JAX package's native library bit for bit, and
both agree with their numpy plain versions; the PNG unfilter equals the
row loop for each filter type; `read_png` equals PIL's
`Image.open(p).convert("RGB")` exactly on RGB, RGBA and gray files written
by PIL and by `write_png`."""

import zlib

import numpy as np
import pytest

from ag2video_tpu.data import native as j_native
from ag2video_torch.data import native as t_native
from ag2video_torch.data import png as t_png
from ag2video_torch.data.transforms import IMG_MEAN, IMG_STD

# The plain resize works in float64 coordinates and numpy's float32 order,
# the library in float32 with its own order: the outputs (|x| < 2.7) differ
# by a few float32 ulps.
PLAIN_RESIZE_ATOL = 1e-5

# (T, H, W) -> (outH, outW): down, up, odd, and 1x1 sources.
RESIZES = [((3, 24, 32), (16, 16)), ((2, 10, 14), (37, 29)),
           ((4, 31, 17), (7, 9)), ((1, 1, 1), (5, 3))]


@pytest.fixture(scope="module")
def jax_lib():
    assert j_native.available(), "the JAX package's native/ library"
    return j_native


@pytest.mark.parametrize("src,out", RESIZES,
                         ids=[f"{s[1]}x{s[2]}to{o[0]}x{o[1]}"
                              for s, o in RESIZES])
def test_clip_resize_normalize_matches(jax_lib, src, out):
    frames = np.random.RandomState(sum(src)).randint(
        0, 256, src + (3,)).astype(np.uint8)
    got = t_native.clip_resize_normalize(frames, out, IMG_MEAN, IMG_STD)
    want = jax_lib.clip_resize_normalize(frames, out, IMG_MEAN, IMG_STD)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (src[0],) + out + (3,)
    np.testing.assert_array_equal(got, want)
    # one thread and four give the same bits
    np.testing.assert_array_equal(t_native.clip_resize_normalize(
        frames, out, IMG_MEAN, IMG_STD, n_threads=1), got)
    plain = t_native.resize_normalize_plain(frames, out, IMG_MEAN, IMG_STD)
    np.testing.assert_allclose(got, plain, rtol=0, atol=PLAIN_RESIZE_ATOL)


@pytest.mark.parametrize("o_cap", [2, 5, 9])
def test_pad_boxes_matches(jax_lib, o_cap):
    boxes = np.random.RandomState(o_cap).uniform(0, 1, (4, 5, 4))
    got = t_native.pad_boxes(boxes, o_cap, -1.0)
    np.testing.assert_array_equal(got, jax_lib.pad_boxes(boxes, o_cap, -1.0))
    np.testing.assert_array_equal(got, t_native.pad_boxes_plain(boxes, o_cap))
    assert t_native.version() == jax_lib.get_lib().agtpu_version() == 1


def _filtered(rng, kinds, row_bytes):
    rows = rng.randint(0, 256, (len(kinds), 1 + row_bytes)).astype(np.uint8)
    rows[:, 0] = kinds
    return rows.tobytes()


@pytest.mark.parametrize("kind", range(5),
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_png_unfilter_matches_the_row_loop(kind, bpp):
    rng = np.random.RandomState(10 * kind + bpp)
    # every row of this type, then the type between rows of the others
    for kinds in ([kind] * 6, [(kind + k) % 5 for k in range(7)]):
        data = _filtered(rng, kinds, 5 * bpp)
        got = t_native.png_unfilter(data, len(kinds), 5 * bpp, bpp)
        want = t_native.png_unfilter_plain(data, len(kinds), 5 * bpp, bpp)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_png_unfilter_rejects_bad_input():
    data = _filtered(np.random.RandomState(0), [0, 1, 5], 6)
    with pytest.raises(ValueError, match="row 2 has an unknown filter"):
        t_native.png_unfilter(data, 3, 6, 3)
    with pytest.raises(ValueError, match="want 4 rows"):
        t_native.png_unfilter(data, 4, 6, 3)


def _image(mode, seed, shape=(29, 37)):
    """Smooth gradients with noise: PIL's adaptive filtering picks several
    filter types on it."""
    rng = np.random.RandomState(seed)
    ch = {"RGB": 3, "RGBA": 4, "L": 1}[mode]
    y, x = np.mgrid[:shape[0], :shape[1]]
    base = (3 * x + 5 * y)[..., None] + 40 * np.arange(ch)
    img = (base + rng.randint(0, 12, shape + (ch,))) % 256
    img = img.astype(np.uint8)
    return img[..., 0] if mode == "L" else img


@pytest.mark.parametrize("writer", ["pil", "write_png"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
def test_read_png_equals_pil_convert_rgb(tmp_path, writer, mode):
    from PIL import Image

    img = _image(mode, seed=len(mode))
    path = tmp_path / f"{mode}.png"
    if writer == "pil":
        Image.fromarray(img, mode).save(path)
    else:
        t_png.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == mode
        want = np.asarray(im.convert("RGB"))
    got = t_png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_png.read_frame(str(path)), want)


def test_write_png_cycles_the_five_filters(tmp_path):
    img = _image("RGB", seed=3, shape=(11, 6))
    path = tmp_path / "a.png"
    t_png.write_png(path, img)
    data = path.read_bytes()
    start = data.index(b"IDAT") + 4
    (length,) = np.frombuffer(data[start - 8:start - 4], ">u4")
    raw = zlib.decompress(data[start:start + int(length)])
    kinds = np.frombuffer(raw, np.uint8).reshape(11, 1 + 6 * 3)[:, 0]
    np.testing.assert_array_equal(kinds, np.arange(11) % 5)
    np.testing.assert_array_equal(t_png.read_png(path), img)


def test_read_png_rejects_what_it_does_not_read(tmp_path):
    from PIL import Image

    bad = {
        "16-bit": Image.fromarray(np.arange(64, dtype=np.uint16)
                                  .reshape(8, 8) * 999),
        "palette": Image.fromarray(_image("RGB", 1)).convert("P"),
    }
    for name, im in bad.items():
        im.save(tmp_path / f"{name}.png")
        with pytest.raises(ValueError, match="unsupported PNG"):
            t_png.read_png(tmp_path / f"{name}.png")
    good = tmp_path / "good.png"
    t_png.write_png(good, _image("RGB", 4))
    # the same file with IHDR's interlace byte set (Adam7)
    data = good.read_bytes()
    ihdr = bytearray(data[16:29])
    ihdr[12] = 1
    (tmp_path / "i.png").write_bytes(
        data[:8] + t_png._chunk(b"IHDR", bytes(ihdr)) + data[33:])
    with pytest.raises(ValueError, match="interlace 1"):
        t_png.read_png(tmp_path / "i.png")
    data = bytearray(good.read_bytes())
    data[40] ^= 0xFF  # a byte of the IDAT chunk
    (tmp_path / "crc.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        t_png.read_png(tmp_path / "crc.png")
    (tmp_path / "short.png").write_bytes(good.read_bytes()[:60])
    with pytest.raises(ValueError, match="truncated"):
        t_png.read_png(tmp_path / "short.png")
    with pytest.raises(ValueError, match="not a PNG"):
        t_png.read_png(__file__)


def test_read_frame_reads_other_formats_through_pil(tmp_path):
    from PIL import Image

    img = _image("RGB", 5)
    Image.fromarray(img).save(tmp_path / "a.jpg")
    with Image.open(tmp_path / "a.jpg") as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(t_png.read_frame(tmp_path / "a.jpg"), want)
