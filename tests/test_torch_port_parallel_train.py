"""The port's sharded training step against the JAX package's, on
threaded ranks (``_torch_port_ranks``) and the 8-device CPU mesh:
``__graft_entry__._dryrun_impl``'s GPT config (f32, remat) and AdamW
1e-3, three steps of ``make_train_step`` from the same numpy weights and
tokens.

dp2.sp2.tp2, dryrun phase 1's mesh at 8 devices (ring attention over
sp, heads and vocab over tp).

Loss and grad_norm within rel 1e-4 at every step, the final params
gathered within atol 1e-4 (see ``assert_trajectories_close``).  The JAX side runs on a thread of its own
while the port's ranks run, so its compile overlaps them.  The other
dryrun meshes and the pure-dp arm are in
tests/test_torch_port_parallel_fsdp.py and _hybrid.py (one 8-rank
trajectory per file keeps each under 20 s alone)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from _torch_port_ranks import (assert_trajectories_close, dryrun_configs,
                               jax_mesh, jax_trajectory, port_mesh,
                               port_trajectory, ranks, world)
from _torch_port_trees import weights
from ray_tpu.models import gpt as jgpt

STEPS = 3


def _case(seed):
    jcfg, cfg = dryrun_configs()
    tree = weights(jgpt.init_params, jcfg, seed)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (8, 65)).astype(np.int32)
    return jcfg, cfg, tree, toks


def test_train_step_on_dp2_sp2_tp2_matches_jax():
    name = "dp2_sp2_tp2"
    jcfg, cfg, tree, toks = _case(7)
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_trajectory, jax_mesh(name), jcfg, tree, toks,
                         STEPS)
        got = ranks(lambda r: port_trajectory(port_mesh(name), cfg, tree,
                                              toks, STEPS), world(name))
        want = want.result()
    for g in got:
        assert_trajectories_close(g, want)
