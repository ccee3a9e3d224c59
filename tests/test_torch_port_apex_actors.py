"""The port's Ape-X DQN with its replay shards and collectors as actors
of the in-process stand-in ``ray_tpu_torch.core.actors``, against the JAX
package's actor arm run on the same stand-in (``tests/_torch_port_actors.py``
points ``ray_tpu``'s runtime calls at it), on the CPU, in f32: two
collectors with one and with two shards (round-robin adds, sampling by
``g % num_shards``, priorities pushed back to the shard they came from,
shard seeds ``seed + 100 + i``, collector seeds ``seed + 1000 * (i + 1)``),
two ``train()`` iterations from a JAX ``save()`` restored into the port,
held as the inline arms are in ``test_torch_port_apex.py``.  The stand-in
is shut down after each test with no thread left alive.
"""

import pytest

from _torch_port_actors import (apex_iterations_match, jit_apex_init,
                                standin)  # noqa: F401


@pytest.fixture(autouse=True)
def _jit_init(monkeypatch):
    jit_apex_init(monkeypatch)


@pytest.mark.parametrize("shards", [1, 2])
def test_actor_iterations_match_jax(standin, shards):  # noqa: F811
    apex_iterations_match(True, num_rollout_workers=2,
                          num_replay_shards=shards)
