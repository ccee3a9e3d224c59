"""ModelCatalog: observation space -> model, the port of
``ray_tpu/rllib/catalog.py``.  ``get_model`` builds the port's
``models/zoo.py`` ``ActorCritic``: visionnet for image observations,
lstm or gtrxl when ``use_lstm``/``use_attention`` is set, else fcnet;
``get_action_dist`` samples the categorical head with numpy's Gumbel
draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ray_tpu_torch.models.zoo import ActorCritic, ModelConfig


class ModelCatalog:
    @staticmethod
    def get_model(obs_shape: Sequence[int], num_actions: int,
                  model_config: Optional[dict] = None) -> ActorCritic:
        """Pick a trunk from the observation space and the config's
        flags: 3-D obs -> visionnet, use_lstm -> lstm, use_attention ->
        gtrxl, else ``kind`` (fcnet by default)."""
        mc = dict(model_config or {})
        if mc.get("use_lstm"):
            kind = "lstm"
        elif mc.get("use_attention"):
            kind = "gtrxl"
        elif len(obs_shape) == 3:
            kind = "visionnet"
        else:
            kind = mc.get("kind", "fcnet")
        cfg = ModelConfig(
            kind=kind, obs_shape=tuple(obs_shape), num_actions=num_actions,
            fcnet_hiddens=tuple(mc.get("fcnet_hiddens", (256, 256))),
            fcnet_activation=mc.get("fcnet_activation", "tanh"),
            conv_filters=tuple(mc.get("conv_filters",
                                      ((16, 8, 4), (32, 4, 2)))),
            cell_size=mc.get("lstm_cell_size", 256),
            attn_dim=mc.get("attention_dim", 64),
            attn_layers=mc.get("attention_num_layers", 2))
        return ActorCritic(cfg)

    @staticmethod
    def get_action_dist(logits: np.ndarray, *, deterministic: bool = False,
                        rng: Optional[np.random.Generator] = None
                        ) -> np.ndarray:
        """Categorical head (discrete actions): argmax, or the Gumbel
        trick with numpy's draws."""
        if deterministic:
            return logits.argmax(axis=-1)
        rng = rng or np.random.default_rng()
        z = rng.gumbel(size=logits.shape)
        return (logits + z).argmax(axis=-1)
