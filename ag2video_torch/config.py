"""Run configuration and vocabularies, shared with the JAX package.

`ag2video_tpu.config` and `ag2video_tpu.vocab` import neither jax nor flax,
so the port re-exports them instead of copying them.
"""

from ag2video_tpu.config import Config  # noqa: F401
from ag2video_tpu.vocab import get_vocab  # noqa: F401
