"""Inference entry points."""

from ag2video_torch.inference.generate import (  # noqa: F401
    generate, make_inputs)
