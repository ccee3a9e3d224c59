"""The port's DD-PPO (``rllib/ddppo.py``: workers as the members of an
in-process gang) against the JAX package's own ``_DDPPOWorker``,
unchanged, run on two threads with ``CollectiveGroup`` replaced by an
in-test stub whose ``allreduce(flat, op="mean")`` averages the two
threads' vectors (``monkeypatch`` edits no file).

Both start from JAX's ``init_policy_params(PRNGKey(seed))``; the port's
rollout policies are fed the Gumbel noise of each JAX worker's key
stream, so both sample the same actions.  After one and after two
``train()`` iterations of ``DDPPOConfig(env="CartPole-v1",
num_rollout_workers=2, num_envs_per_worker=2, rollout_length=32,
train_batch_size=128, minibatch_size=64, num_epochs=1, seed=3)``: each
rank's params within atol 1e-5 of JAX's, the metrics within rel 1e-5
(atol 1e-7), the same episode returns, and both of the port's ranks
holding bit-equal params (the lockstep of
``tests/test_rllib_distributed_tail.py``)."""

import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from _torch_port_rl import assert_trees_close, assert_trees_equal, np_tree
from ray_tpu.parallel import collectives as jcollectives
from ray_tpu.rllib import ddppo as jddppo
from ray_tpu.rllib import policy as jpolicy
from ray_tpu_torch.rllib import DDPPO, DDPPOConfig

CFG = dict(env="CartPole-v1", num_rollout_workers=2, num_envs_per_worker=2,
           rollout_length=32, train_batch_size=128, minibatch_size=64,
           num_epochs=1, seed=3)
ITERS = 2


class StubGroup:
    """``CollectiveGroup(name, world, rank)`` for threads: ``allreduce``
    stacks the ranks' vectors in rank order and reduces them as the
    real group does."""

    exchanges: dict = {}
    lock = threading.Lock()

    def __init__(self, name, world, rank):
        with StubGroup.lock:
            ex = StubGroup.exchanges.setdefault(
                name, {"barrier": threading.Barrier(world),
                       "slots": [None] * world})
        self.ex, self.rank = ex, rank

    def allreduce(self, x, op="sum"):
        ex = self.ex
        ex["slots"][self.rank] = np.asarray(x)
        ex["barrier"].wait(60)
        stack = np.stack(ex["slots"])
        out = stack.mean(0) if op == "mean" else stack.sum(0)
        ex["barrier"].wait(60)
        return out


class JaxKeys:
    """A JAX policy's key stream: each call splits the key as
    ``JaxPolicy.compute_actions`` does and returns the Gumbel noise that
    ``jax.random.categorical`` adds to the [B, A] logits."""

    def __init__(self, seed: int, shape):
        self.rng, self.shape = jax.random.PRNGKey(seed), tuple(shape)

    @staticmethod
    @functools.partial(jax.jit, static_argnums=1)
    def _next(rng, shape):
        rng, sub = jax.random.split(rng)
        return rng, jax.random.gumbel(sub, shape)

    def __call__(self):
        self.rng, g = self._next(self.rng, self.shape)
        return np.asarray(g)


def jax_iterations(monkeypatch, params):
    """The unchanged JAX workers, two threads, ``ITERS`` train_once each:
    per iteration [(rank 0 result, params), (rank 1 ...)]."""
    monkeypatch.setattr(jcollectives, "CollectiveGroup", StubGroup)
    cfg = jddppo.DDPPOConfig(**CFG)
    workers = [jddppo._DDPPOWorker(cfg, r, 2, "ddppo-test") for r in (0, 1)]
    for w in workers:
        w.set_weights(params)
    out = [[None, None] for _ in range(ITERS)]
    errors = []

    def run(r):
        try:
            for it in range(ITERS):
                res = workers[r].train_once()
                out[it][r] = (res, np_tree(workers[r].get_weights()))
        except BaseException as e:       # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    return out


@pytest.fixture(scope="module")
def iterated():
    pcfg = jpolicy.PolicyConfig(obs_dim=4, num_actions=2, hiddens=(64, 64))
    params = np_tree(jpolicy.init_policy_params(
        pcfg, jax.random.PRNGKey(CFG["seed"])))
    mp = pytest.MonkeyPatch()
    # the JAX workers compile and run on their own threads meanwhile
    ex = ThreadPoolExecutor(1)
    jax_run = ex.submit(jax_iterations, mp, params)
    algo = DDPPOConfig(**CFG, device="cpu").build()
    algo.load_checkpoint({"params": params})
    for r, w in enumerate(algo.workers):
        w.worker.policy.gumbel_fn = JaxKeys(
            CFG["seed"] + 1000 * r + 1, (CFG["num_envs_per_worker"], 2))
    got = []
    for _ in range(ITERS):
        n = len(algo._ep_returns)
        res = algo.train()
        got.append((res, list(algo._ep_returns[n:]),
                    [w.get_weights() for w in algo.workers]))
    try:
        want = jax_run.result()
    finally:
        mp.undo()
        ex.shutdown()
    yield want, got
    algo.cleanup()


@pytest.mark.parametrize("it", range(ITERS))
def test_each_rank_matches_the_jax_worker(iterated, it):
    want, got = iterated
    res, returns, weights = got[it]
    for r in (0, 1):
        assert_trees_close(weights[r], want[it][r][1], atol=1e-5,
                           err=f"iteration {it + 1} rank {r}")
    jres = [w[0] for w in want[it]]
    assert returns == [x for j in jres for x in j["episode_returns"]]
    assert res["steps_this_iter"] == sum(j["count"] for j in jres) == 256
    for k in ("policy_loss", "vf_loss", "entropy", "kl", "total_loss"):
        np.testing.assert_allclose(res[k], np.mean([j[k] for j in jres]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("it", range(ITERS))
def test_ranks_stay_in_lockstep(iterated, it):
    _, got = iterated
    w0, w1 = got[it][2]
    assert_trees_equal(w0, w1, err=f"iteration {it + 1}")


def test_save_and_restore_keep_the_layout(iterated):
    _, got = iterated
    algo = DDPPOConfig(**CFG, device="cpu").build()
    try:
        saved = {"params": got[-1][2][0], "timesteps": 512}
        algo.restore({"_iteration": 2, "payload": saved})
        ck = algo.save()
        assert ck["_iteration"] == 2 and set(ck["payload"]) == \
            {"params", "timesteps"}
        assert ck["payload"]["timesteps"] == 512
        for w in algo.workers:
            assert_trees_equal(w.get_weights(), saved["params"])
        assert algo.train()["steps_this_iter"] == 256
    finally:
        algo.cleanup()


def test_one_worker_raises_and_device_none_needs_a_card(monkeypatch):
    with pytest.raises(ValueError, match="num_rollout_workers >= 2"):
        DDPPOConfig(**{**CFG, "num_rollout_workers": 1},
                    device="cpu").build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DDPPOConfig(**CFG).build()
