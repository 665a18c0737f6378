"""Dataset vocabularies, shared with the JAX package (jax-free)."""

from ag2video_tpu.vocab import get_vocab  # noqa: F401
