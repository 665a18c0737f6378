"""Model modules, one per module of ag2video_tpu/models."""

from ag2video_torch.models.meta import AG2VideoModel  # noqa: F401
