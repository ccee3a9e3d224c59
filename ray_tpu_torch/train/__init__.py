"""Training: the train step on one device or a mesh (``step.py``), checkpoints
(``checkpoint.py``), the trainer loop with failover resume
(``trainer.py``, its session in ``session.py``) and the predictor
(``predictor.py``), ports of the same modules of ``ray_tpu/train``."""

from ray_tpu_torch.train.checkpoint import (AsyncCheckpointer, Checkpoint,
                                            CheckpointManager)
from ray_tpu_torch.train.predictor import Predictor, TorchPredictor
from ray_tpu_torch.train.step import (TrainState, adam, adamw, device_batch,
                                      load_state, make_train_step,
                                      shard_batch, state_shardings,
                                      state_to_host)
from ray_tpu_torch.train.trainer import Result, Trainer, TrainingFailedError

__all__ = ["AsyncCheckpointer", "Checkpoint", "CheckpointManager",
           "Predictor", "TorchPredictor", "TrainState", "adam", "adamw",
           "device_batch", "load_state", "make_train_step", "shard_batch",
           "state_shardings", "state_to_host",
           "Result", "Trainer", "TrainingFailedError"]
