"""The port's GIF encoder (ag2video_torch/utils/gif.py) against two
independent decoders, imageio's and PIL's: each reads back exactly the
encoder's quantized frames, with the frame count, the loop and the delay
(250 ms at fps 4) written; the sizes at the edges (1x1, odd), a noisy clip
whose first frame alone fills the LZW table (4,096 codes) and clears it,
runs of one colour, short runs cut by the clears, and every value of
every channel, each within the palette's stated worst error."""

import io

import imageio.v3 as iio
import numpy as np
import pytest
from PIL import Image

from ag2video_torch.utils import gif


def _every_value():
    x, y = np.meshgrid(np.arange(256), np.arange(256))
    return np.stack([x, y, (x + y) % 256], -1)[None].repeat(2, 0)


def _runs(rng):
    """Runs of 1-8 pixels of random colours: a clear every ~6,000 pixels
    falls inside a run."""
    n = 2 * 256 * 256
    values = rng.randint(0, 256, (n, 3))
    lengths = rng.randint(1, 9, n)
    pixels = np.repeat(values, lengths, axis=0)[:n]
    return pixels.reshape(2, 256, 256, 3)


CLIPS = {
    "1x1": lambda rng: rng.randint(0, 256, (2, 1, 1, 3)),
    "odd": lambda rng: rng.randint(0, 256, (3, 7, 13, 3)),
    "noisy_64x64x8": lambda rng: rng.randint(0, 256, (8, 64, 64, 3)),
    "one_colour": lambda rng: np.full((3, 17, 9, 3), 200),
    "runs_256x256": _runs,
    "every_value": lambda rng: _every_value(),
}


def _pil_frames(data):
    frames = []
    with Image.open(io.BytesIO(data)) as im:
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
    return np.stack(frames)


@pytest.mark.parametrize("name", list(CLIPS))
def test_decoders_read_the_quantized_frames(name):
    frames = CLIPS[name](np.random.RandomState(0)).astype(np.uint8)
    data = gif.encode_gif(list(frames), fps=4)
    want = gif.quantize_frames(frames)
    np.testing.assert_array_equal(
        iio.imread(data, index=None, extension=".gif")[..., :3], want)
    np.testing.assert_array_equal(_pil_frames(data), want)
    meta = iio.immeta(data, extension=".gif")
    assert meta["loop"] == 0 and meta["duration"] == 250
    with Image.open(io.BytesIO(data)) as im:
        assert im.n_frames == len(frames) and im.size == frames.shape[2:0:-1]
        assert im.info["loop"] == 0 and im.info["duration"] == 250
    assert np.abs(want.astype(int) - frames).max() <= gif.MAX_ERROR


def test_palette_and_its_worst_error():
    assert gif.PALETTE.shape == (256, 3) and gif.PALETTE.dtype == np.uint8
    assert gif.MAX_ERROR == 25
    frames = _every_value().astype(np.uint8)
    err = np.abs(gif.quantize_frames(frames).astype(int) - frames)
    # every value 0..255 of every channel: the bound is reached, not passed
    assert err.max() == gif.MAX_ERROR
    # on a palette colour the error is 0
    colours = gif.PALETTE[None, None, :252]
    np.testing.assert_array_equal(gif.quantize_frames(colours), colours)


def test_noisy_clip_clears_the_full_table():
    frames = CLIPS["noisy_64x64x8"](np.random.RandomState(0)).astype(
        np.uint8)
    codes, widths = gif.lzw_codes(gif.palette_indices(frames)[0])
    clear = 1 << gif.MIN_CODE_SIZE
    assert codes[0] == clear and codes[-1] == clear + 1
    # a clear code mid-stream, when the table holds 4,096 codes: 258 fixed
    # and one defined by each code after the first (the encoder is one
    # ahead of the decoder), at 12 bits
    clears = np.flatnonzero(codes == clear)
    assert len(clears) >= 2 and clears[1] == 1 + gif.SEGMENT
    assert gif.FIRST + gif.SEGMENT == gif.MAX_CODES == 4096
    assert widths.max() == 12 and widths.min() == gif.MIN_CODE_SIZE + 1


def test_delay_follows_fps_and_bad_frames_raise():
    frames = np.zeros((2, 4, 4, 3), np.uint8)
    data = gif.encode_gif(list(frames), fps=10)
    assert iio.immeta(data, extension=".gif")["duration"] == 100
    with pytest.raises(ValueError):
        gif.encode_gif([np.zeros((4, 4, 3), np.float32)])
    with pytest.raises(ValueError):
        gif.encode_gif([np.zeros((4, 4), np.uint8)])
    # a frame of more pixels than the longest run one table can code
    with pytest.raises(ValueError, match="pixels"):
        gif.encode_gif([np.zeros((113, 65535, 3), np.uint8)])
