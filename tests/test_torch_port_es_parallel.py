"""ES and ARS with ``eval_parallelism > 0``: the candidates' episodes run
as tasks of the port's in-process stand-in ``ray_tpu_torch.core.actors``,
against the JAX package's parallel arm run on the same stand-in
(``tests/_torch_port_actors.py`` points ``ray_tpu``'s runtime calls at
it) and against the port's inline arm, on the CPU, in f32: two
iterations from a JAX ``save()`` with JAX's perturbations fed in; the
returns and theta within atol 1e-5 of JAX's, the observation filter's
moments (ARS) within rel 1e-12, folded in candidate order; the inline
arm's results equal exactly.
"""

import numpy as np
import pytest

from _torch_port_actors import standin  # noqa: F401
from ray_tpu.rllib import es as jes
from ray_tpu_torch.rllib import es as tes


@pytest.mark.parametrize("which", ["es", "ars"])
def test_parallel_evaluation_matches_jax_and_inline(standin, which):  # noqa: F811,E501
    jcls, tcls = ((jes.ESConfig, tes.ESConfig) if which == "es"
                  else (jes.ARSConfig, tes.ARSConfig))
    kw = dict(env="CartPole-v1", pop_size=3, max_episode_steps=30,
              hiddens=(16,), seed=0)
    if which == "ars":
        kw["top_directions"] = 2
    j = jcls(**kw, eval_parallelism=2).build()
    par = tcls(**kw, eval_parallelism=2, device="cpu").build()
    inline = tcls(**kw, device="cpu").build()
    for t in (par, inline):
        t.restore(j.save())
    for it in range(2):
        _, eps, _ = j._perturb(j._rng, j.theta)
        jr = j.train()
        tr, ir = (t.iterate(eps=np.asarray(eps)) for t in (par, inline))
        for t in (par, inline):
            t._iteration += 1        # train() counts; iterate() does not
        for k in ("steps_this_iter", "pop_return_mean", "pop_return_max"):
            np.testing.assert_allclose(tr[k], jr[k], atol=1e-5,
                                       err_msg=f"{k} {it}")
            assert tr[k] == ir[k], (k, it)
        assert par._ep_returns == inline._ep_returns
        np.testing.assert_allclose(par._ep_returns, j._ep_returns,
                                   atol=1e-5)
        np.testing.assert_allclose(par.theta.numpy(), np.asarray(j.theta),
                                   atol=1e-5, err_msg=f"iteration {it}")
        assert np.array_equal(par.theta.numpy(), inline.theta.numpy())
    assert par._obs_n == inline._obs_n == j._obs_n
    if which == "ars":
        assert par._obs_n > 0
    for got in (par, inline):
        np.testing.assert_allclose(got._obs_sum, j._obs_sum, rtol=1e-12)
        np.testing.assert_allclose(got._obs_sq, j._obs_sq, rtol=1e-12)
