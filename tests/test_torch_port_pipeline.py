"""The port's pipeline schedules against the JAX package's, on threaded
ranks (``_torch_port_ranks``) and the 8-device CPU mesh, f32, inputs
from a numpy seed.

- ``build_1f1b_schedule``: all eight tables equal the JAX package's for
  (S, M) in (2, 2), (2, 4), (4, 4), (4, 8), (3, 7), T = 2(M + S - 1);
  fewer microbatches than stages raise.
- ``pipeline_apply`` on a toy residual stage (``x + tanh(x w + b)`` per
  layer) at pp2 and pp4, and on a mesh without pp, with and without
  ``carry_aux``: outputs, aux and the gradients of ``sum(out * c) +
  aux`` for the layers and the input within 1e-5 of JAX's
  ``pipeline_apply`` (``_single_stage`` without pp) under ``jax.grad``.
- ``pipeline_value_and_grads_1f1b`` on tests/test_parallel.py's
  ``test_1f1b_value_and_grads_parity`` toy (S4, M8, L8, D16, MB4): loss
  within 1e-5 of JAX's, dP, dT, dX within rtol 1e-4, atol 1e-5.
- The collective-order invariant: a pp2, M = 4 pipeline whose stage 0
  ignores the hand-off it receives (the reference's ``where``) finishes
  under the rank helper's timeout, forward and backward.
- Nothing under ray_tpu_torch/, nor chip_smoke.py, imports
  ``torch.distributed.pipelining``: the schedules are the reference's
  tick tables, over the port's own collectives.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch.distributed.tensor import Replicate, Shard

from _torch_port_ranks import ranks
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu.parallel.pipeline import _single_stage as jsingle_stage
from ray_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from ray_tpu.parallel.pipeline_1f1b import (
    build_1f1b_schedule as jbuild_1f1b_schedule)
from ray_tpu.parallel.pipeline_1f1b import (
    pipeline_value_and_grads_1f1b as jvalue_and_grads_1f1b)
from ray_tpu_torch.parallel import create_mesh
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.pipeline_1f1b import (
    build_1f1b_schedule, pipeline_value_and_grads_1f1b)
from ray_tpu_torch.parallel.sharding import local_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)


# -- the 1F1B tables -------------------------------------------------------------

@pytest.mark.parametrize("S,M", [(2, 2), (2, 4), (4, 4), (4, 8), (3, 7)])
def test_1f1b_schedule_equals_jax(S, M):
    got, want = build_1f1b_schedule(S, M), jbuild_1f1b_schedule(S, M)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got.do_f.shape[0] == 2 * (M + S - 1)
    assert got.do_f.sum(axis=0).tolist() == [M] * S
    assert got.do_b.sum(axis=0).tolist() == [M] * S


def test_1f1b_needs_a_microbatch_per_stage():
    with pytest.raises(ValueError, match="microbatches >= stages"):
        build_1f1b_schedule(4, 3)


# -- GPipe on a toy stage --------------------------------------------------------

L, D, MB, M = 4, 8, 3, 4


def _toy(seed):
    rng = np.random.default_rng(seed)
    layers = {"w": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32)}
    x_mb = rng.standard_normal((M, MB, D)).astype(np.float32)
    c = rng.standard_normal((M, MB, D)).astype(np.float32)
    return layers, x_mb, c


def _jax_stage(carry_aux):
    def block(lp, x):
        return lax.scan(lambda h, p: (h + jnp.tanh(h @ p["w"] + p["b"]),
                                      None), x, lp)[0]
    if not carry_aux:
        return block

    def stage(lp, x, aux):
        y = block(lp, x)
        return y, aux + 0.01 * jnp.sum(y * y)
    return stage


def _port_stage(carry_aux):
    def block(lp, x):
        for w, b in zip(lp["w"].unbind(0), lp["b"].unbind(0)):
            x = x + torch.tanh(x @ w + b)
        return x
    if not carry_aux:
        return block

    def stage(lp, x, aux):
        y = block(lp, x)
        return y, aux + 0.01 * (y * y).sum()
    return stage


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("carry_aux", [False, True])
def test_pipeline_apply_matches_jax(S, carry_aux):
    """S = 1 is the degenerate path: a mesh without pp (the JAX package's
    ``_single_stage``, which its ``pipeline_apply`` reaches on a pp1
    mesh; both packages' meshes drop an axis of size 1)."""
    layers, x_mb, c = _toy(S + 10 * carry_aux)
    jstage = _jax_stage(carry_aux)
    if S > 1:
        jmesh = jcreate_mesh({"pp": S}, devices=jax.devices("cpu")[:S])
        jrun = functools.partial(jpipeline_apply, mesh=jmesh)
    else:
        jrun = jsingle_stage

    def jloss(layers, x_mb):
        res = jrun(jstage, x_mb, layers, carry_aux=carry_aux)
        out, aux = res if carry_aux else (res, 0.0)
        return jnp.sum(out * c) + aux, (out, aux)

    (_, (jout, jaux)), (jdl, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(layers, x_mb)

    def rank(r):
        mesh = create_mesh({"pp": S} if S > 1 else {"dp": 1}, device="cpu")
        stacked = (Shard(0),) if S > 1 else (Replicate(),)
        lp = {k: local_shard(torch.from_numpy(v), mesh, stacked)
              .requires_grad_(True) for k, v in layers.items()}
        x = local_shard(torch.from_numpy(x_mb), mesh,
                        (Replicate(),)).requires_grad_(True)
        res = pipeline_apply(_port_stage(carry_aux), x, lp, mesh=mesh,
                             carry_aux=carry_aux)
        out, aux = res if carry_aux else (res, None)
        loss = (out.to_local() * torch.from_numpy(c)).sum()
        if carry_aux:
            loss = loss + aux.to_local()
        grads = torch.autograd.grad(loss, [lp["w"], lp["b"], x])
        return (out.to_local().detach().numpy(),
                None if aux is None else aux.to_local().item(),
                [g.full_tensor().numpy() for g in grads])

    for out, aux, (dw, db, dx) in ranks(rank, S):
        np.testing.assert_allclose(out, np.asarray(jout), **TOL)
        if carry_aux:
            np.testing.assert_allclose(aux, float(jaux), **TOL)
        np.testing.assert_allclose(dw, np.asarray(jdl["w"]), **TOL)
        np.testing.assert_allclose(db, np.asarray(jdl["b"]), **TOL)
        np.testing.assert_allclose(dx, np.asarray(jdx), **TOL)


def test_a_stage_ignoring_its_hand_off_does_not_hang():
    """Stage 0 never reads what it receives (it takes a fresh microbatch
    every tick), so the hand-off's backward would run on every rank but
    it if the ignored input left its graph; the ranks then wait for each
    other until the helper's timeout.  Here they finish, and stage 0's
    layers get the gradient of every microbatch."""
    layers, x_mb, c = _toy(3)

    def rank(r):
        mesh = create_mesh({"pp": 2}, device="cpu")
        lp = {k: local_shard(torch.from_numpy(v), mesh, (Shard(0),))
              .requires_grad_(True) for k, v in layers.items()}
        out = pipeline_apply(_port_stage(False), torch.from_numpy(x_mb), lp,
                             mesh=mesh)
        (dw,) = torch.autograd.grad((out.to_local() * torch.from_numpy(c))
                                    .sum(), [lp["w"]])
        return dw.to_local().abs().sum(dim=(1, 2)).numpy()

    for dw in ranks(rank, 2, timeout=30):
        assert (dw > 0).all()


# -- 1F1B on test_1f1b_value_and_grads_parity's toy --------------------------------

def test_1f1b_value_and_grads_match_jax():
    S, M1, L1, D1, MB1 = 4, 8, 8, 16, 4
    rng = np.random.RandomState(0)
    layers = {"w": (rng.randn(L1, D1, D1) * 0.1).astype(np.float32),
              "b": np.zeros((L1, D1), np.float32)}
    tail = {"wo": (rng.randn(D1, 7) * 0.1).astype(np.float32)}
    x_mb = rng.randn(M1, MB1, D1).astype(np.float32)
    y_mb = rng.randint(0, 7, (M1, MB1)).astype(np.int32)

    def jstage(lp, x):
        return lax.scan(lambda h, p: (h + jnp.tanh(h @ p["w"] + p["b"]),
                                      None), x, lp)[0]

    def jlast(tp, x, y):
        logits = x @ tp["wo"]
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, y[:, None], 1)[:, 0]
        return jnp.mean(logz - gold)

    jmesh = jcreate_mesh({"pp": S}, devices=jax.devices("cpu")[:S])
    want = jax.jit(lambda *a: jvalue_and_grads_1f1b(
        jstage, jlast, *a, mesh=jmesh))(x_mb, y_mb, layers, tail)

    def last(tp, x, y):
        return torch.nn.functional.cross_entropy(x @ tp["wo"], y.long())

    def rank(r):
        mesh = create_mesh({"pp": S}, device="cpu")
        loss, dP, dT, dX = pipeline_value_and_grads_1f1b(
            _port_stage(False), last, torch.from_numpy(x_mb),
            torch.from_numpy(y_mb),
            {k: torch.from_numpy(v) for k, v in layers.items()},
            {k: torch.from_numpy(v) for k, v in tail.items()}, mesh=mesh)
        return (loss.to_local().item(),
                {k: v.full_tensor().numpy() for k, v in dP.items()},
                dT["wo"].full_tensor().numpy(), dX.full_tensor().numpy())

    jl, jdP, jdT, jdX = want
    grad_tol = dict(rtol=1e-4, atol=1e-5)
    for loss, dP, dT, dX in ranks(rank, S):
        assert abs(loss - float(jl)) < 1e-5
        for k in layers:
            np.testing.assert_allclose(dP[k], np.asarray(jdP[k]), **grad_tol)
        np.testing.assert_allclose(dT, np.asarray(jdT["wo"]), **grad_tol)
        np.testing.assert_allclose(dX, np.asarray(jdX), **grad_tol)


# -- the port's own schedules ----------------------------------------------------

def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "ray_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_does_not_import_torch_pipelining():
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not name.startswith("torch.distributed.pipelining"), \
                    f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"
