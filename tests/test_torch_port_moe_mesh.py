"""Mixture-of-experts GPT on a mesh with experts split over ep, against
the JAX package, on threaded ranks (``_torch_port_ranks``) and the
8-device CPU mesh, f32, weights and tokens from a numpy seed.

- ``tiny_moe`` on dp2.ep2 (tests/test_parallel.py's
  ``test_moe_ep_mesh_parity``): the loss and the aux loss summed over
  layers within 1e-5 of the JAX package's ``forward``/``loss_fn`` on the
  same mesh.  The aux loss is E sum_e f_e P_e with both means over every
  group and token of the mesh: each dp rank's own product, averaged,
  would be another number.
- ``__graft_entry__._dryrun_impl``'s MoE config (4 experts, top-2,
  remat) on dp2.ep2.tp2, dryrun phase 5's mesh: three steps of
  ``make_train_step`` (AdamW 1e-3), loss and grad_norm within rel 1e-4
  at every step, the final params gathered within atol 1e-4 (see
  ``assert_trajectories_close``).
The MoE + pp composition is in tests/test_torch_port_moe_pp.py."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_ranks import (assert_trajectories_close, dryrun_configs,
                               jax_mesh, jax_trajectory, port_mesh,
                               port_trajectory, ranks, world)
from _torch_port_trees import weights
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train.step import shard_batch

STEPS = 3
MOE = dict(n_experts=4, expert_top_k=2)


def test_moe_loss_and_aux_on_dp2_ep2_match_jax():
    name = "dp2_ep2"
    jcfg, cfg = jgpt.GPTConfig.tiny_moe(), tgpt.GPTConfig.tiny_moe()
    tree = weights(jgpt.init_params, jcfg, 16)
    toks = np.random.default_rng(16).integers(
        0, cfg.vocab_size, (4, 33)).astype(np.int32)
    jmesh = jax_mesh(name)

    def jfn(p, t):
        _, aux = jgpt.forward(p, t[:, :-1], jcfg, mesh=jmesh,
                              return_aux=True)
        return jgpt.loss_fn(p, {"tokens": t}, jcfg, mesh=jmesh), aux

    with jmesh:
        want_loss, want_aux = (float(v) for v in jax.jit(jfn)(tree, toks))

    def rank(r):
        mesh = port_mesh(name)
        params = convert.params_from_numpy(
            tree, mesh=mesh, logical=tgpt.param_logical_axes(cfg))
        batch = shard_batch({"tokens": toks}, mesh)
        with torch.no_grad():
            _, aux = tgpt.forward(params, batch["tokens"][:, :-1], cfg,
                                  mesh=mesh, return_aux=True)
            loss = tgpt.loss_fn(params, batch, cfg, mesh=mesh)
        return loss.to_local().item(), aux.to_local().item()

    for loss, aux in ranks(rank, world(name)):
        assert abs(loss - want_loss) < 1e-5, (loss, want_loss)
        assert abs(aux - want_aux) < 1e-5, (aux, want_aux)


def test_moe_train_step_on_dp2_ep2_tp2_matches_jax():
    name = "dp2_ep2_tp2"
    jcfg, cfg = dryrun_configs(**MOE)
    tree = weights(jgpt.init_params, jcfg, 17)
    toks = np.random.default_rng(17).integers(
        0, cfg.vocab_size, (8, 65)).astype(np.int32)
    with ThreadPoolExecutor(1) as ex:
        want = ex.submit(jax_trajectory, jax_mesh(name), jcfg, tree, toks,
                         STEPS)
        got = ranks(lambda r: port_trajectory(port_mesh(name), cfg, tree,
                                              toks, STEPS), world(name))
        want = want.result()
    for g in got:
        assert_trajectories_close(g, want)
