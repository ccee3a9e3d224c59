"""The port's training step on a pp mesh against the JAX package's, on
threaded ranks (``_torch_port_ranks``) and the 8-device CPU mesh:
``__graft_entry__._dryrun_impl``'s GPT config (f32, remat) on
pp2.dp2.tp2, dryrun phase 4's mesh (a GPipe pipeline of 4 microbatches
over 2 stages of one layer, each stage's layer split over tp and its
rows over dp), AdamW 1e-3, three steps of ``make_train_step`` from the
same numpy weights and tokens.

Loss and grad_norm within rel 1e-4 at every step, the final params
gathered within atol 1e-4 (see ``assert_trajectories_close``).  The JAX
package's state is put back on its shardings between steps (Queue C,
R1).  A leaf replicated over pp (the embedding, the head) that took its
gradient once per stage would show in grad_norm at step 1."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from _torch_port_ranks import (assert_trajectories_close, dryrun_configs,
                               jax_mesh, jax_trajectory, port_mesh,
                               port_trajectory, ranks, world)
from _torch_port_trees import weights
from ray_tpu.models import gpt as jgpt

STEPS = 3


def test_train_step_on_pp2_dp2_tp2_matches_jax():
    name = "pp2_dp2_tp2"
    jcfg, cfg = dryrun_configs()
    tree = weights(jgpt.init_params, jcfg, 15)
    toks = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (8, 65)).astype(np.int32)
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_trajectory, jax_mesh(name), jcfg, tree, toks,
                         STEPS)
        got = ranks(lambda r: port_trajectory(port_mesh(name), cfg, tree,
                                              toks, STEPS), world(name))
        want = want.result()
    for g in got:
        assert_trajectories_close(g, want)
