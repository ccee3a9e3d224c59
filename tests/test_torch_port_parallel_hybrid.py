"""The port's sharded training step against the JAX package's on the
hybrid mesh dcn2.dp2.tp2 (dcn outermost): dryrun phase 3's mesh without
its sp axis, which would need 16 devices (the CPU mesh of the tests has
8).  As tests/test_torch_port_parallel_train.py: three steps, loss and
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


def test_train_step_on_dcn2_dp2_tp2_matches_jax():
    name = "dcn2_dp2_tp2"
    jcfg, cfg = dryrun_configs()
    tree = weights(jgpt.init_params, jcfg, 10)
    toks = np.random.default_rng(10).integers(
        0, cfg.vocab_size, (8, 65)).astype(np.int32)
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_trajectory, jax_mesh(name), jcfg, tree, toks,
                         STEPS)
        got = ranks(lambda r: port_trajectory(port_mesh(name), cfg, tree,
                                              toks, STEPS), world(name))
        want = want.result()
    for g in got:
        assert_trajectories_close(g, want)
