"""The port's sharded training step against the JAX package's, as in
tests/test_torch_port_parallel_train.py:

- dp2.fsdp2.tp2, in place of dryrun phase 2's dp2.fsdp2.sp2.tp2, which
  needs 16 devices (the CPU mesh of the tests has 8); fsdp splits the
  batch, as DEFAULT_LLM_RULES keep "embed" whole;
- the pure-dp arm of ``make_train_step`` (no logical axes: every leaf
  replicated) on dp4.

Loss and grad_norm within rel 1e-4 at every step, the final params
gathered within atol 1e-4 (see ``assert_trajectories_close``)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

from _torch_port_ranks import (assert_trajectories_close, dryrun_configs,
                               jax_mesh, jax_trajectory, port_mesh,
                               port_trajectory, ranks, world)
from _torch_port_trees import weights
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu_torch.parallel import create_mesh

STEPS = 3


def _case(seed):
    jcfg, cfg = dryrun_configs()
    tree = weights(jgpt.init_params, jcfg, seed)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (8, 65)).astype(np.int32)
    return jcfg, cfg, tree, toks


def test_train_step_on_dp2_fsdp2_tp2_matches_jax():
    name = "dp2_fsdp2_tp2"
    jcfg, cfg, tree, toks = _case(9)
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_trajectory, jax_mesh(name), jcfg, tree, toks,
                         STEPS)
        got = ranks(lambda r: port_trajectory(port_mesh(name), cfg, tree,
                                              toks, STEPS), world(name))
        want = want.result()
    for g in got:
        assert_trajectories_close(g, want)


def test_pure_dp_train_step_matches_jax():
    jcfg, cfg, tree, toks = _case(8)
    jmesh = jcreate_mesh({"dp": 4}, devices=jax.devices("cpu"))
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_trajectory, jmesh, jcfg, tree, toks, STEPS,
                         sharded=False)
        got = ranks(lambda r: port_trajectory(
            create_mesh({"dp": 4}, device="cpu"), cfg, tree, toks, STEPS,
            sharded=False), 4)
        want = want.result()
    for g in got:
        assert_trajectories_close(g, want)
