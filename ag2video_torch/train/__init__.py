"""Training (port of ag2video_tpu/train): the training state with its three
Adams, the trainer's G / D / graph steps, its validation pass and `fit`,
and the checkpoints."""

from ag2video_torch.train.state import TrainState, create_train_state  # noqa: F401
from ag2video_torch.train.trainer import Trainer  # noqa: F401
