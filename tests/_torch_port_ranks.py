"""Threaded ranks for the port's sharded tests, and the JAX package's
meshes to hold them to.  Not a test module.

``ranks(fn, n)`` runs ``fn(rank)`` on ``n`` threads of this process, each
a rank of torch.distributed's threaded process group, and returns their
results in rank order (``ray_tpu_torch.parallel.run_ranks``).  The ranks
are joined under ``TIMEOUT`` seconds in all; a rank that raises fails
the test with its own traceback, and c10d's world and thread-isolation
mode are restored whatever happens.  No subprocess, no sleep."""

import jax
import numpy as np
import pytest

from ray_tpu.parallel.mesh import create_hybrid_mesh as jcreate_hybrid_mesh
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu_torch.parallel import (RankError, create_hybrid_mesh,
                                    create_mesh, run_ranks)

TIMEOUT = 60.0

# the meshes the sharded tests run on, as (dcn, ICI axes): dcn None is a
# plain mesh, otherwise a hybrid one with dcn outermost
MESHES = {
    "dp2": (None, {"dp": 2}),
    "dp2_tp2": (None, {"dp": 2, "tp": 2}),
    "dp2_fsdp2": (None, {"dp": 2, "fsdp": 2}),
    "dp2_sp2": (None, {"dp": 2, "sp": 2}),
    "dp2_tp4": (None, {"dp": 2, "tp": 4}),
    "dp2_sp4": (None, {"dp": 2, "sp": 4}),
    "dp2_sp2_tp2": (None, {"dp": 2, "sp": 2, "tp": 2}),
    "dp2_fsdp2_tp2": (None, {"dp": 2, "fsdp": 2, "tp": 2}),
    "dcn2_dp2_tp2": (2, {"dp": 2, "tp": 2}),
    "pp2": (None, {"pp": 2}),
    "pp4_dp2": (None, {"pp": 4, "dp": 2}),
    "pp2_dp2_tp2": (None, {"pp": 2, "dp": 2, "tp": 2}),
    "dp2_ep2": (None, {"dp": 2, "ep": 2}),
    "dp2_ep2_tp2": (None, {"dp": 2, "ep": 2, "tp": 2}),
    "pp2_dp2_ep2": (None, {"pp": 2, "dp": 2, "ep": 2}),
}


def ranks(fn, n: int, timeout: float = TIMEOUT) -> list:
    try:
        return run_ranks(fn, n, timeout=timeout)
    except RankError as exc:
        pytest.fail(str(exc), pytrace=False)


def port_mesh(name: str):
    """The port's mesh ``name`` over the threaded world (call in a rank)."""
    dcn, axes = MESHES[name]
    if dcn is None:
        return create_mesh(axes, device="cpu")
    return create_hybrid_mesh(axes, dcn, device="cpu")


def jax_mesh(name: str):
    """The JAX package's mesh ``name`` on the CPU devices."""
    dcn, axes = MESHES[name]
    devices = jax.devices("cpu")
    if dcn is None:
        return jcreate_mesh(axes, devices=devices)
    return jcreate_hybrid_mesh(axes, dcn, devices=devices)


def world(name: str) -> int:
    dcn, axes = MESHES[name]
    n = dcn or 1
    for v in axes.values():
        n *= v
    return n


# -- the sharded train step, both sides ------------------------------------------

def dryrun_configs(**extra):
    """``__graft_entry__._dryrun_impl``'s GPT config (f32, remat), the
    JAX package's and the port's; ``extra`` adds fields (its MoE config's
    ``n_experts=4, expert_top_k=2``)."""
    import jax.numpy as jnp
    import torch

    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.models import gpt as tgpt

    kw = dict(vocab_size=512, max_seq=64, d_model=64, n_heads=4,
              n_layers=2, d_ff=128, remat=True, **extra)
    return (jgpt.GPTConfig(dtype=jnp.float32, **kw),
            tgpt.GPTConfig(dtype=torch.float32, **kw))


def jax_trajectory(jmesh, jcfg, tree, tokens, steps, sharded=True):
    """``steps`` of the JAX package's ``make_train_step`` (AdamW 1e-3) on
    ``jmesh``: [(loss, grad_norm)] and the final params as numpy.  Its
    step is jitted with the state's shardings in and XLA's choice out, so
    the state is put back on the state's shardings between steps (the
    second call refuses the first one's output otherwise)."""
    import optax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel.mesh import replicated
    from ray_tpu.parallel.sharding import DEFAULT_LLM_RULES
    from ray_tpu.train.step import (make_train_step, shard_batch,
                                    state_shardings)

    logical = jgpt.param_logical_axes(jcfg) if sharded else None
    tx = optax.adamw(1e-3)
    init_fn, step_fn = make_train_step(
        lambda p, b: jgpt.loss_fn(p, b, jcfg, mesh=jmesh), tx, mesh=jmesh,
        params_logical=logical)
    with jmesh:
        state = init_fn(tree)
        if sharded:
            sh = state_shardings(jmesh, logical, DEFAULT_LLM_RULES, tree, tx)
        else:
            sh = jax.tree.map(lambda _: replicated(jmesh), state)
        batch = shard_batch({"tokens": tokens}, jmesh)
        out = []
        for _ in range(steps):
            state, m = step_fn(state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
            state = jax.device_put(state, sh)
        params = jax.tree.map(np.asarray, state.params)
    return out, params


def port_trajectory(mesh, cfg, tree, tokens, steps, sharded=True):
    """The same on the port's ``mesh`` (call in a rank): the params enter
    as DTensors (``params_from_numpy(..., mesh=)``) when ``sharded``,
    else as whole tensors that ``init_fn`` replicates."""
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.train.step import adamw, make_train_step, shard_batch

    logical = tgpt.param_logical_axes(cfg) if sharded else None
    init_fn, step_fn = make_train_step(
        lambda p, b: tgpt.loss_fn(p, b, cfg, mesh=mesh), adamw(1e-3),
        mesh=mesh, params_logical=logical)
    params = (convert.params_from_numpy(tree, mesh=mesh, logical=logical)
              if sharded else convert.params_from_numpy(tree, device="cpu"))
    state = init_fn(params)
    batch = shard_batch({"tokens": tokens}, mesh)
    out = []
    for _ in range(steps):
        state, m = step_fn(state, batch)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out, convert.params_to_numpy(state.params)


def assert_trajectories_close(got, want):
    """Loss and grad_norm within rel 1e-4 at every step, the final params
    within atol 1e-4.  Adam turns the f32 noise of a near-zero gradient
    (sums taken in another order) into parameter noise: the JAX package
    on this config, dp2.fsdp2.tp2 against one device, ends three steps
    1e-5 to 4e-5 apart, so a tighter bound would fail the reference
    against itself."""
    (g_steps, g_params), (w_steps, w_params) = got, want
    for i, (g, w) in enumerate(zip(g_steps, w_steps)):
        np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=f"step {i}")
    gl, wl = (jax.tree_util.tree_leaves_with_path(t)
              for t in (g_params, w_params))
    for (path, a), (_, b) in zip(sorted(gl, key=lambda x: str(x[0])),
                                 sorted(wl, key=lambda x: str(x[0]))):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
