"""Training: data and shards, losses, the optimizer, the trainer, early
stopping, and weights and checkpoints."""

from nanodecoder_tpu_torch.train.loss import label_smoothed_nll, loss_and_metrics  # noqa: F401
from nanodecoder_tpu_torch.train.optim import build_optimizer, noam_schedule  # noqa: F401
from nanodecoder_tpu_torch.train.trainer import Trainer, TrainState, make_train_step  # noqa: F401
from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager  # noqa: F401
