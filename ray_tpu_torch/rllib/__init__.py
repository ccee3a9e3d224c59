"""RLlib on one device, the port of ``ray_tpu/rllib``, PPO first:
numpy envs (``env.py``), ``SampleBatch``, the actor-critic policy
(``policy.py``), the inline rollout worker, ``Algorithm`` and its
config, and ``PPO``."""

from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           WorkerSet)
from ray_tpu_torch.rllib.env import CartPole, Pendulum, VectorEnv, make_env
from ray_tpu_torch.rllib.policy import (PolicyConfig, TorchPolicy,
                                        compute_gae, init_policy_params,
                                        policy_forward)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, make_ppo_update, ppo_loss
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch

__all__ = ["Algorithm", "AlgorithmConfig", "WorkerSet", "CartPole",
           "Pendulum", "VectorEnv", "make_env", "PolicyConfig",
           "TorchPolicy", "compute_gae", "init_policy_params",
           "policy_forward", "PPO", "PPOConfig", "make_ppo_update",
           "ppo_loss", "RolloutWorker", "SampleBatch"]
