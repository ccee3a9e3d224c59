"""``LearnerGroup(2)`` on the port's in-process stand-in
``ray_tpu_torch.core.actors`` against the JAX package's group run on the
same stand-in (``tests/_torch_port_actors.py`` points ``ray_tpu``'s
runtime calls at it), on the CPU, in f32, at ``tests/test_rl_module.py``'s
settings: two learner actors from the same seed; each update splits the
batch's rows at ``np.linspace`` bounds (every learner takes the whole
batch when it has fewer rows than learners) and sets the mean of the
learners' params on every one.

Each update starts from the JAX learners' state (learner i's params and
Adam moments into the port's learner i): the group's loss within rel
1e-5 and its averaged params within atol 1e-5 of JAX's, every port
learner holding the same params; over the run the loss falls (the JAX
test's bar), also for a port group left to run on its own from JAX's
initial state.  Free
runs of the two packages drift apart by more than that: at the test's lr
0.05 the first Adam step overshoots (loss 37 -> 165) and one inline
``Learner`` of each package, from equal states, differs by 1.2e-5 rel in
its second loss and 2.8e-5 in its params, a precision effect of f32 and
the two Adam formulas, not of the group.
"""

import jax
import numpy as np

from _torch_port_actors import instance, standin  # noqa: F401
from _torch_port_rl import assert_trees_close, assert_trees_equal, np_tree
from ray_tpu.rllib import rl_module as jrl
from ray_tpu_torch.rllib import rl_module as trl


def _pg_batch(rng, n=64, obs_dim=4, num_actions=2):
    """``tests/test_rl_module.py``'s batch."""
    return {"obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, num_actions, n).astype(np.int64),
            "advantages": rng.normal(size=n).astype(np.float32),
            "value_targets": rng.normal(size=n).astype(np.float32)}


def _groups(ent_coeff=0.0, seed=3):
    jg = jrl.LearnerGroup(lambda: jrl.DiscretePGModule(
        obs_dim=4, num_actions=2, ent_coeff=ent_coeff), 2, lr=0.05,
        seed=seed)
    tg = trl.LearnerGroup(lambda: trl.DiscretePGModule(
        obs_dim=4, num_actions=2, ent_coeff=ent_coeff), 2, lr=0.05,
        seed=seed, device="cpu")
    assert jg._distributed and tg._distributed
    assert jg.num_learners == tg.num_learners == 2
    return jg, tg


def _from_jax(jg, tg):
    """Each port learner's params and Adam state from its JAX twin's."""
    for j, t in zip(jg._learners, tg._learners):
        j = instance(j)
        instance(t).set_state({"params": j.get_weights(),
                               "opt_state": np_tree(j.opt_state)})


def _same_on_every_learner(tg):
    ws = [instance(lrn).get_weights() for lrn in tg._learners]
    assert_trees_equal(ws[1], ws[0])


def _updates_match(jg, tg, batches):
    losses = []
    for i, batch in enumerate(batches):
        _from_jax(jg, tg)
        jl, tl = jg.update(batch)["loss"], tg.update(batch)["loss"]
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, err_msg=f"update {i}")
        assert_trees_close(tg.get_weights(), jg.get_weights(), atol=1e-5,
                           err=f"update {i}")
        _same_on_every_learner(tg)
        losses.append(jl)
    return losses


def test_learner_group_matches_jax(standin):  # noqa: F811
    jg, tg = _groups()
    # a second port group from JAX's initial state, left to run on its own
    own = trl.LearnerGroup(lambda: trl.DiscretePGModule(
        obs_dim=4, num_actions=2, ent_coeff=0.0), 2, lr=0.05, seed=3,
        device="cpu")
    _from_jax(jg, own)
    batch = _pg_batch(np.random.default_rng(3), n=128)
    losses = _updates_match(jg, tg, [batch] * 6)
    assert losses[-1] < losses[0]          # sync-DP averaging still learns
    first = own.update(batch)["loss"]
    for _ in range(5):
        last = own.update(batch)["loss"]
    assert last < first
    _same_on_every_learner(own)
    for g in (jg, tg, own):
        g.stop()


def test_learner_group_with_fewer_rows_than_learners(standin):  # noqa: F811
    jg, tg = _groups(ent_coeff=0.01, seed=0)
    rng = np.random.default_rng(5)
    _updates_match(jg, tg, [_pg_batch(rng, n=1) for _ in range(2)])
    assert all(np.isfinite(leaf).all()
               for leaf in jax.tree_util.tree_leaves(tg.get_weights()))
    jg.stop()
    tg.stop()
