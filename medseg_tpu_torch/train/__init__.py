"""Training: losses, schedules, freezing, the train and eval steps,
checkpoints and the two-stage classification trainer."""

from medseg_tpu_torch.train.trainer import TrainResult, train_model  # noqa: F401
