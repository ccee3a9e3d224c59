"""Mixture of experts and the GPipe pipeline together, against the JAX
package: ``__graft_entry__._dryrun_impl``'s MoE config (4 experts,
top-2, remat, f32) on pp2.dp2.ep2, dryrun phase 6's mesh, three steps of
``make_train_step`` (AdamW 1e-3) on threaded ranks
(``_torch_port_ranks``) and the 8-device CPU mesh.

The aux loss rides the pipeline's hand-off: the reference's value is
the mean over microbatches of each microbatch's aux (each microbatch's
means spanning its rows on every dp rank), not the unpipelined model's
(tests/test_parallel.py's ``test_moe_pp_composition`` allows 5e-4
between those two); the port is held to the pipelined one.  Loss and
grad_norm within rel 1e-4 at every step, the final params gathered
within atol 1e-4 (see ``assert_trajectories_close``)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from _torch_port_ranks import (assert_trajectories_close, dryrun_configs,
                               jax_mesh, jax_trajectory, port_mesh,
                               port_trajectory, ranks, world)
from _torch_port_trees import weights
from ray_tpu.models import gpt as jgpt

STEPS = 3


def test_moe_train_step_on_pp2_dp2_ep2_matches_jax():
    name = "pp2_dp2_ep2"
    jcfg, cfg = dryrun_configs(n_experts=4, expert_top_k=2)
    tree = weights(jgpt.init_params, jcfg, 18)
    toks = np.random.default_rng(18).integers(
        0, cfg.vocab_size, (8, 65)).astype(np.int32)
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_trajectory, jax_mesh(name), jcfg, tree, toks,
                         STEPS)
        got = ranks(lambda r: port_trajectory(port_mesh(name), cfg, tree,
                                              toks, STEPS), world(name))
        want = want.result()
    for g in got:
        assert_trajectories_close(g, want)
