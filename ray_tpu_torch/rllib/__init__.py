"""RLlib on one device, the port of ``ray_tpu/rllib``: numpy envs
(``env.py``), ``SampleBatch``, the actor-critic policy (``policy.py``),
the inline rollout worker, ``Algorithm`` and its config; the on-policy
learners PPO, PG, A2C, IMPALA and APPO; the replay learners DQN,
SimpleQ, SAC, DDPG and TD3 over ``replay_buffer.py``; the offline ones
BC, MARWIL, CQL and DT over ``offline.py``; the bandits LinUCB and
LinTS; ES and ARS; the RLModule / Learner / LearnerGroup stack; the
recurrent, multi-agent and slate learners R2D2, QMIX, MADDPG, SlateQ and
multi-agent PPO; the planning and model-based ones AlphaZero, MAML,
MB-MPO and Dreamer; and the host-side ModelCatalog, connectors and
PolicyServerInput / PolicyClient; and DD-PPO, whose workers are the
members of an in-process gang.  Exported under the JAX package's names;
Ape-X and AlphaStar are not ported."""

from ray_tpu_torch.rllib.a2c import A2C, A2CConfig
from ray_tpu_torch.rllib.algorithm import (Algorithm, AlgorithmConfig,
                                           WorkerSet)
from ray_tpu_torch.rllib.alpha_zero import (MCTS, AlphaZero,
                                            AlphaZeroConfig, GridGoal,
                                            RankedRewardsBuffer)
from ray_tpu_torch.rllib.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.bandit import (BanditConfig, LinTS, LinUCB,
                                        LinearBanditEnv)
from ray_tpu_torch.rllib.bc import BC, BCConfig, MARWIL, MARWILConfig
from ray_tpu_torch.rllib.catalog import ModelCatalog
from ray_tpu_torch.rllib.connectors import (ClipActions, ClipReward,
                                            Connector, ConnectorPipeline,
                                            FlattenObs, FrameStack,
                                            MeanStdFilter, UnsquashActions)
from ray_tpu_torch.rllib.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.ddpg import DDPG, DDPGConfig, TD3, TD3Config
from ray_tpu_torch.rllib.ddppo import DDPPO, DDPPOConfig
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, SimpleQ, SimpleQConfig
from ray_tpu_torch.rllib.dreamer import (Dreamer, DreamerConfig,
                                         LinearLatentEnv)
from ray_tpu_torch.rllib.dt import DT, DTConfig
from ray_tpu_torch.rllib.env import CartPole, Pendulum, VectorEnv, make_env
from ray_tpu_torch.rllib.es import ARS, ARSConfig, ES, ESConfig
from ray_tpu_torch.rllib.impala import Impala, ImpalaConfig, vtrace
from ray_tpu_torch.rllib.maddpg import MADDPG, MADDPGConfig, SpreadLine
from ray_tpu_torch.rllib.maml import MAML, MAMLConfig, SinusoidTasks
from ray_tpu_torch.rllib.mbmpo import MBMPO, MBMPOConfig
from ray_tpu_torch.rllib.multi_agent import (MultiAgentCartPole,
                                             MultiAgentEnv, MultiAgentPPO,
                                             MultiAgentPPOConfig,
                                             MultiAgentRolloutWorker)
from ray_tpu_torch.rllib.offline import (JsonReader, JsonWriter,
                                         importance_sampling_estimate)
from ray_tpu_torch.rllib.pg import PG, PGConfig
from ray_tpu_torch.rllib.policy import (PolicyConfig, TorchPolicy,
                                        compute_gae, init_policy_params,
                                        policy_forward)
from ray_tpu_torch.rllib.policy_server import (PolicyClient,
                                               PolicyServerInput)
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, make_ppo_update, ppo_loss
from ray_tpu_torch.rllib.qmix import QMIX, QMIXConfig, TeamSwitch
from ray_tpu_torch.rllib.r2d2 import R2D2, R2D2Config
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
from ray_tpu_torch.rllib.slateq import (InterestEvolution, SlateQ,
                                        SlateQConfig)

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
           "RolloutWorker", "SAC", "SACConfig", "SampleBatch",
           "AlphaZero", "AlphaZeroConfig", "GridGoal", "MCTS",
           "RankedRewardsBuffer", "SlateQ", "SlateQConfig",
           "InterestEvolution", "ModelCatalog", "MBMPO", "MBMPOConfig",
           "MultiAgentEnv", "MultiAgentCartPole", "MultiAgentPPO",
           "MultiAgentPPOConfig", "MultiAgentRolloutWorker", "Connector",
           "ConnectorPipeline", "FlattenObs", "MeanStdFilter",
           "FrameStack", "ClipReward", "ClipActions", "UnsquashActions",
           "PolicyClient", "PolicyServerInput", "R2D2", "R2D2Config",
           "QMIX", "QMIXConfig", "TeamSwitch", "MADDPG", "MADDPGConfig",
           "SpreadLine", "Dreamer", "DreamerConfig", "LinearLatentEnv",
           "MAML", "MAMLConfig", "SinusoidTasks", "DDPPO", "DDPPOConfig"]
