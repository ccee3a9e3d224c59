"""RLlib on one device, the port of ``ray_tpu/rllib``: numpy envs
(``env.py``), ``SampleBatch``, the actor-critic policy (``policy.py``),
the inline rollout worker, ``Algorithm`` and its config; the on-policy
learners PPO, PG, A2C, IMPALA and APPO; the replay learners DQN,
SimpleQ, SAC, DDPG and TD3 over ``replay_buffer.py``; the offline ones
BC, MARWIL, CQL and DT over ``offline.py``; the bandits LinUCB and
LinTS; ES and ARS; and the RLModule / Learner / LearnerGroup stack.
Exported under the JAX package's names."""

from ray_tpu_torch.rllib.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           WorkerSet)
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.bandit import (BanditConfig, LinTS, LinUCB,
                                        LinearBanditEnv)
from ray_tpu_torch.rllib.bc import BC, BCConfig, MARWIL, MARWILConfig
from ray_tpu_torch.rllib.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.ddpg import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, SimpleQ, SimpleQConfig
from ray_tpu_torch.rllib.dt import DT, DTConfig
from ray_tpu_torch.rllib.env import CartPole, Pendulum, VectorEnv, make_env
from ray_tpu_torch.rllib.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig, vtrace
from ray_tpu_torch.rllib.offline import (JsonReader, JsonWriter,
                                         importance_sampling_estimate)
from ray_tpu_torch.rllib.pg import PG, PGConfig
from ray_tpu_torch.rllib.policy import (PolicyConfig, TorchPolicy,
                                        compute_gae, init_policy_params,
                                        policy_forward)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, make_ppo_update, ppo_loss
from ray_tpu_torch.rllib.replay_buffer import (MinSegmentTree,
                                               PrioritizedReplayBuffer,
                                               ReplayBuffer,
                                               ReservoirReplayBuffer,
                                               SumSegmentTree)
from ray_tpu_torch.rllib.rl_module import (DiscretePGModule, Learner,
                                           LearnerGroup, MultiRLModule,
                                           RLModule)
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sac import SAC, SACConfig
from ray_tpu_torch.rllib.sample_batch import SampleBatch

__all__ = ["A2C", "A2CConfig", "Algorithm", "AlgorithmConfig", "WorkerSet",
           "APPO", "APPOConfig", "BanditConfig", "LinTS", "LinUCB",
           "LinearBanditEnv", "BC", "BCConfig", "MARWIL", "MARWILConfig",
           "CQL", "CQLConfig", "DDPG", "DDPGConfig", "TD3", "TD3Config",
           "DQN", "DQNConfig", "SimpleQ", "SimpleQConfig", "DT", "DTConfig",
           "CartPole", "Pendulum", "VectorEnv", "make_env", "ARS",
           "ARSConfig", "ES", "ESConfig", "Impala", "ImpalaConfig",
           "vtrace", "JsonReader", "JsonWriter",
           "importance_sampling_estimate", "PG", "PGConfig",
           "PolicyConfig", "TorchPolicy", "compute_gae",
           "init_policy_params", "policy_forward", "PPO", "PPOConfig",
           "make_ppo_update", "ppo_loss", "MinSegmentTree",
           "PrioritizedReplayBuffer", "ReplayBuffer",
           "ReservoirReplayBuffer", "SumSegmentTree", "DiscretePGModule",
           "Learner", "LearnerGroup", "MultiRLModule", "RLModule",
           "RolloutWorker", "SAC", "SACConfig", "SampleBatch"]
