"""Training: the single-device train step of ``ray_tpu/train/step.py``."""

from ray_tpu_torch.train.step import TrainState, adamw, make_train_step

__all__ = ["TrainState", "adamw", "make_train_step"]
