"""ag2video-torch: the PyTorch / CUDA port of ag2video-tpu for one NVIDIA H100.

Module names mirror the JAX package (`ag2video_tpu`), which stays in the
repository as the reference the port is tested against. The port imports
torch and never jax or flax. Public tensors keep the JAX layout: videos are
(B, T, H, W, C), boxes xywh in [0, 1].
"""

from ag2video_torch.config import Config, get_vocab  # noqa: F401

__version__ = "0.1.0"
