"""Test glue for the actor arms: the port's in-process stand-in
``ray_tpu_torch.core.actors``, initialised for one test, with the JAX
package's runtime calls (``ray_tpu.is_initialized``, ``remote``, ``get``,
``wait``, ``put``, ``kill``) pointed at it, so the JAX arms run on the
same threads with no runtime and no edit to ``ray_tpu/``.  After the test
it is shut down and no stand-in thread may be left alive.  ``JaxKeys``
feeds a port worker's policy the Gumbel noise of its JAX twin."""

import functools
import threading

import jax
import numpy as np
import pytest

import ray_tpu
from ray_tpu_torch.core import actors

CALLS = ("is_initialized", "remote", "get", "wait", "put", "kill")


def live_threads() -> list:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(actors.THREAD_PREFIX)]


@pytest.fixture
def standin(monkeypatch):
    actors.init()
    for name in CALLS:
        monkeypatch.setattr(ray_tpu, name, getattr(actors, name))
    try:
        yield actors
    finally:
        actors.shutdown()
        assert live_threads() == []


class JaxKeys:
    """A JAX policy's key stream: each call splits the key as
    ``JaxPolicy.compute_actions`` does and returns the Gumbel noise
    ``jax.random.categorical`` adds to the logits.  A JAX
    ``RolloutWorker(seed=s)`` keys its policy ``s + 1``."""

    def __init__(self, seed: int, shape: tuple):
        self.rng, self.shape = jax.random.PRNGKey(seed), shape

    @staticmethod
    @functools.partial(jax.jit, static_argnums=1)
    def _next(rng, shape):
        rng, sub = jax.random.split(rng)
        return rng, jax.random.gumbel(sub, shape)

    def __call__(self):
        self.rng, g = self._next(self.rng, self.shape)
        return np.asarray(g)


def instance(handle):
    """The object an actor of the stand-in holds (a test reaches into it,
    e.g. to feed a policy JAX's noise)."""
    return actors.get(handle._built)


# tests/test_rllib_extra.py's Ape-X settings
APEX = dict(env="CartPole-v1", num_envs_per_worker=2,
            collect_steps_per_round=32, train_rounds_per_iter=2,
            grad_steps_per_round=2, learning_starts=32, batch_size=16,
            seed=0)


def jit_apex_init(monkeypatch):
    """The JAX Ape-X's Q-net init as one jit (eagerly each op compiles on
    its own); the port restores the learner's params from a JAX save and
    the collectors' are overwritten by the first weight push."""
    import jax
    from ray_tpu.rllib import apex as japex
    monkeypatch.setattr(japex, "init_q_params", jax.jit(
        japex.init_q_params, static_argnums=(0, 1, 2, 3)))


def apex_iterations_match(distributed: bool, **kw) -> None:
    """The JAX Ape-X and the port's, restored from its initial save, over
    two ``train()`` iterations: the replay shards' columns and the episode
    returns exact, ``steps_this_iter`` and ``replay_size`` equal,
    ``mean_td_loss`` within rel 1e-4, the params and target params
    within atol 1e-5."""
    import numpy as np

    from _torch_port_rl import assert_trees_close
    from ray_tpu.rllib import apex as japex
    from ray_tpu_torch.rllib import apex as tapex

    def shard_cols(algo):
        bufs = [instance(s).buf if distributed else s.buf
                for s in algo.shards]
        return [b._cols for b in bufs]

    jalgo = japex.ApexDQNConfig(**APEX, **kw).build()
    port = tapex.ApexDQNConfig(**APEX, **kw, device="cpu").build()
    try:
        assert jalgo._distributed is port._distributed is distributed
        assert len(port.shards) == len(jalgo.shards)
        assert len(port.collectors) == len(jalgo.collectors)
        port.restore(jalgo.save())
        for it in range(2):
            jr, tr = jalgo.train(), port.train()
            for k in ("steps_this_iter", "replay_size"):
                assert jr[k] == tr[k] > 0, (k, it)
            np.testing.assert_allclose(tr["mean_td_loss"],
                                       jr["mean_td_loss"], rtol=1e-4)
            assert port._ep_returns == jalgo._ep_returns
            assert_trees_close(port.params, jalgo.params, atol=1e-5,
                               err=f"iteration {it}")
            assert_trees_close(port.target_params, jalgo.target_params,
                               atol=1e-5, err=f"iteration {it} target")
            for jc, tc in zip(shard_cols(jalgo), shard_cols(port)):
                assert set(jc) == set(tc)
                for k in jc:
                    assert np.array_equal(jc[k], tc[k]), (it, k)
        assert port.opt.count == int(jalgo.opt_state[0].count) > 0
    finally:
        jalgo.cleanup()
        port.cleanup()
