"""The port's Ape-X DQN against the JAX package's on the CPU, in f32,
inline (one replay shard, ``max(1, num_rollout_workers)`` collectors):

- at the settings of ``tests/test_rllib_extra.py``'s Ape-X test, two
  ``train()`` iterations with 0 and with 2 collectors from a JAX
  ``save()`` restored into the port: the replay columns and episode
  returns exact, ``steps_this_iter`` and ``replay_size`` equal,
  ``mean_td_loss`` within rel 1e-4, params and target params within
  atol 1e-5 (the collectors' exploration and the replay draw from numpy
  with the JAX package's seeds);
- a JAX ``save()`` restored into the port and back (optax state
  bridged); ``device=None`` without a card raises.  The actor arm is in
  ``test_torch_port_apex_actors.py``.
"""

import numpy as np
import pytest
import torch

from _torch_port_actors import APEX, apex_iterations_match, jit_apex_init
from _torch_port_rl import assert_trees_equal, np_tree
from ray_tpu.rllib import apex as japex
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import apex as tapex


@pytest.fixture(autouse=True)
def _jit_init(monkeypatch):
    jit_apex_init(monkeypatch)


@pytest.mark.parametrize("workers", [0, 2])
def test_inline_iterations_match_jax(workers):
    apex_iterations_match(False, num_rollout_workers=workers)


def test_jax_save_restores_into_the_port_and_back():
    jalgo = japex.ApexDQNConfig(**APEX, num_rollout_workers=0).build()
    jalgo.train()
    saved = jalgo.save()
    port = tapex.ApexDQNConfig(**dict(APEX, seed=4), num_rollout_workers=0,
                               device="cpu").build()
    port.restore(saved)
    assert port.iteration == 1 and port._timesteps == jalgo._timesteps
    assert_trees_equal(port.params, jalgo.params)
    assert_trees_equal(port.target_params, jalgo.target_params)
    assert_trees_equal(port.collectors[0].params, jalgo.params)
    back = port.save()["payload"]
    opt = convert.torch_adam_to_optax(back["opt_state"],
                                      like=np_tree(jalgo.opt_state))
    assert_trees_equal(opt, jalgo.opt_state)
    other = japex.ApexDQNConfig(**APEX, num_rollout_workers=0).build()
    other.restore({"_iteration": 1, "payload": dict(back, opt_state=opt)})
    assert_trees_equal(other.params, jalgo.params)
    assert_trees_equal(other.collectors[0].params, jalgo.params)
    assert np.isfinite(port.train()["mean_td_loss"])


def test_inline_without_the_standin_and_a_missing_card_raises(monkeypatch):
    algo = tapex.ApexDQNConfig(**APEX, num_rollout_workers=2,
                               device="cpu").build()
    assert not algo._distributed and len(algo.shards) == 1
    assert [c.epsilon for c in algo.collectors] == [0.4, 0.4 ** 8]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapex.ApexDQNConfig(**APEX).build()
