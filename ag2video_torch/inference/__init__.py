"""Inference entry points: `generate`, `GenerationSession`, and the action
builders of the compositionality API (`inference.actions`)."""

from ag2video_torch.inference.generate import (  # noqa: F401
    GenerationSession, generate, make_inputs)
