"""Models of the port: the dense and MoE GPT, BERT, ResNet, the MLP, the
RL catalog (``zoo``) and the JAX params bridge (``convert``)."""

from ray_tpu_torch.models.bert import BERT, BERTConfig
from ray_tpu_torch.models.gpt import GPT, GPTConfig
from ray_tpu_torch.models.mlp import MLP, MLPConfig
from ray_tpu_torch.models.resnet import ResNet, ResNetConfig
from ray_tpu_torch.models.zoo import ActorCritic, ModelConfig

__all__ = ["BERT", "BERTConfig", "GPT", "GPTConfig", "MLP", "MLPConfig",
           "ResNet", "ResNetConfig", "ActorCritic", "ModelConfig"]
