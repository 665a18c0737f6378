"""Clip-level image transforms (port of ag2video_tpu/data/transforms.py;
reference models/group_transforms.py, models/video_transforms.py,
data/utils.py:21-80).

The port's frames are (H, W, 3) uint8 arrays, not PIL images. The default
branch of `clip_transform` (resize, no flip) goes to the host library
(data/native.py) and needs no PIL. The `crop` branch and the resize of the
flip branch use PIL's resamplers, as the JAX module does: PIL is imported
inside them, and where it is absent they raise an ImportError that names
the branch. A group transform applies one sampled transform to every frame
of a clip; the output is float32 NHWC, ImageNet-normalized.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ag2video_torch.data import native

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pil(branch: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"clip_transform's {branch} branch needs PIL (Pillow) for its "
            f"resampling; the default branch (resize_or_crop='resize', no "
            f"flip) does not") from e
    return Image


def group_resize(frames: Sequence[np.ndarray], size: Tuple[int, int],
                 branch: str = "resize with flip") -> List[np.ndarray]:
    """Resize every frame to (H, W) with PIL's bilinear filter (reference
    GroupResize)."""
    Image = _pil(branch)
    H, W = size
    return [np.asarray(Image.fromarray(f).resize((W, H), Image.BILINEAR))
            for f in frames]


def group_flip(frames: Sequence[np.ndarray], flip: bool) -> List[np.ndarray]:
    """Mirror every frame left to right (PIL's FLIP_LEFT_RIGHT)."""
    if not flip:
        return list(frames)
    return [np.ascontiguousarray(f[:, ::-1]) for f in frames]


def group_multi_scale_crop(
    frames: Sequence[np.ndarray],
    output_size: Tuple[int, int],
    rng: np.random.RandomState,
    scales=(1.0, 0.875, 0.75, 0.66),
    fix_crop: bool = True,
) -> List[np.ndarray]:
    """Multi-scale fixed-offset crop (reference GroupMultiScaleCrop,
    models/video_transforms.py:5-81): sample a crop size from `scales` of
    the short side and one of 13 fixed offsets, identically per frame."""
    Image = _pil("crop")
    h, w = frames[0].shape[:2]
    base = min(w, h)
    crop_sizes = [int(base * s) for s in scales]
    cw = crop_sizes[rng.randint(len(crop_sizes))]
    ch = crop_sizes[rng.randint(len(crop_sizes))]

    if fix_crop:
        w_step = (w - cw) // 4
        h_step = (h - ch) // 4
        offsets = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
                   (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step),
                   (0, 2 * h_step), (4 * w_step, 2 * h_step),
                   (2 * w_step, 0), (2 * w_step, 4 * h_step),
                   (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                   (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
        ox, oy = offsets[rng.randint(len(offsets))]
    else:
        ox = rng.randint(max(w - cw, 0) + 1)
        oy = rng.randint(max(h - ch, 0) + 1)

    H, W = output_size
    return [np.asarray(Image.fromarray(f).crop((ox, oy, ox + cw, oy + ch))
                       .resize((W, H), Image.BILINEAR)) for f in frames]


def to_normalized_array(frames: Sequence[np.ndarray]) -> np.ndarray:
    """uint8 frames -> (T, H, W, 3) float32, ImageNet normalized."""
    arr = np.stack([np.asarray(f, np.float32) / 255.0 for f in frames])
    return (arr - IMG_MEAN) / IMG_STD


def denormalize(img: np.ndarray) -> np.ndarray:
    """ImageNet-normalized -> [0, 1] (reference data/utils.py deprocess)."""
    return np.clip(np.asarray(img) * IMG_STD + IMG_MEAN, 0.0, 1.0)


def clip_transform(
    frames: Sequence[np.ndarray],
    image_size: Tuple[int, int],
    resize_or_crop: str = "resize",
    train: bool = False,
    no_flip: bool = True,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """The standard clip pipeline (reference set_transforms,
    cater.py:143-150: resize -> tensor -> normalize; optional crop/flip
    variants per resize_or_crop) over (H, W, 3) uint8 frames."""
    rng = rng or np.random.RandomState(0)
    if resize_or_crop == "resize":
        if no_flip or not train:
            # The hot path: the host library's resize + normalize, frame-
            # threaded with the interpreter lock released.
            return native.clip_resize_normalize(np.stack(frames), image_size,
                                                IMG_MEAN, IMG_STD)
        frames = group_resize(frames, image_size)
    elif resize_or_crop == "crop":
        frames = group_multi_scale_crop(frames, image_size, rng)
    else:
        frames = group_resize(frames, image_size,
                              branch=f"resize_or_crop={resize_or_crop!r}")
    if train and not no_flip:
        frames = group_flip(frames, bool(rng.randint(2)))
    return to_normalized_array(frames)
