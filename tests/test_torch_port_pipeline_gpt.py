"""GPT and BERT on a pp mesh against the JAX package, on threaded ranks
(``_torch_port_ranks``) and the 8-device CPU mesh, f32, weights and
tokens from a numpy seed, params entering through
``params_from_numpy(..., mesh=, logical=)``.

- GPT's loss on pp2 with tests/test_parallel.py's
  ``test_pipeline_forward_matches_single_device`` config (4 layers, M =
  4): within 1e-5 of the JAX package's pp2 loss.
- BERT's ``encode`` on pp2 with ``test_pipeline_bert_parity``'s config:
  within atol 1e-5 of the JAX package's pipelined encoder.
- The refusals the JAX package makes, before any collective: sp and pp
  on one mesh, ``return_kv`` on a pp mesh, an ``attention_mask`` on a pp
  mesh, layers or a batch that the stages or microbatches do not
  divide, and 1F1B with fewer microbatches than stages.
- On pp2.dp2 with remat "dots" each rank launches the flash forward
  2 T L/S times and each backward kernel T L/S times a step (T = M + S
  - 1 ticks: every stage computes at every tick, bubbles included) at
  its [mb/2, h, s, hd] shape.
- The 1F1B GPT pass on pp4.dp2 (dryrun phase 7's config) on bridged
  params: the loss within 1e-5 and every leaf's gradient within rtol
  1e-4, atol 1e-5 of the same pass built from the JAX package's pieces
  (``ray_tpu/train/step.py`` ``train_step_1f1b``'s body), and
  ``train_step_1f1b`` itself (its own parity and grad-norm checks).
"""

import importlib
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_ranks import jax_mesh, port_mesh, ranks, world
from _torch_port_trees import weights
from ray_tpu.models import bert as jbert
from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.parallel import create_mesh
from ray_tpu_torch.train.step import (gpt_value_and_grads_1f1b, shard_batch,
                                      train_step_1f1b)

port_flash = importlib.import_module("ray_tpu_torch.ops.flash_attention")

PP_KW = dict(vocab_size=256, max_seq=32, d_model=32, n_heads=2, n_layers=4,
             d_ff=64, remat=False, pp_microbatches=4)


def _configs(**kw):
    kw = {**PP_KW, **kw}
    return (jgpt.GPTConfig(dtype=jnp.float32, **kw),
            tgpt.GPTConfig(dtype=torch.float32, **kw))


def test_gpt_loss_on_pp2_matches_jax():
    jcfg, cfg = _configs()
    tree = weights(jgpt.init_params, jcfg, 11)
    toks = np.random.default_rng(11).integers(0, 256, (8, 33)).astype(np.int32)
    jmesh = jax_mesh("pp2")
    with jmesh:
        want = float(jax.jit(lambda p, b: jgpt.loss_fn(
            p, b, jcfg, mesh=jmesh))(tree, {"tokens": toks}))

    def rank(r):
        mesh = port_mesh("pp2")
        params = convert.params_from_numpy(
            tree, mesh=mesh, logical=tgpt.param_logical_axes(cfg))
        loss = tgpt.loss_fn(params, shard_batch({"tokens": toks}, mesh), cfg,
                            mesh=mesh)
        return loss.to_local().item()

    for loss in ranks(rank, 2):
        assert abs(loss - want) < 1e-5, (loss, want)


def test_bert_encode_on_pp2_matches_jax():
    cfg = tbert.BERTConfig.tiny(n_layers=2, pp_microbatches=2)
    jcfg = jbert.BERTConfig.tiny(n_layers=2, pp_microbatches=2)
    tree = weights(jbert.init_params, jcfg, 12)
    ids = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    jmesh = jax_mesh("pp2")
    with jmesh:
        want = np.asarray(jax.jit(lambda p, t: jbert.encode(
            p, t, jcfg, mesh=jmesh))(tree, ids))

    def rank(r):
        mesh = port_mesh("pp2")
        params = convert.params_from_numpy(
            tree, mesh=mesh, logical=tbert.param_logical_axes(cfg))
        ids_d = shard_batch({"ids": ids}, mesh)["ids"]
        return tbert.encode(params, ids_d, cfg, mesh=mesh).full_tensor() \
            .detach().numpy()

    for got in ranks(rank, 2):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pp_mesh_refusals_match_jax():
    """Each raises as the JAX package raises, before any collective (the
    meshes stand in with their axis names and sizes)."""
    def stand_in(**axes):
        return SimpleNamespace(mesh_dim_names=tuple(axes),
                               shape=tuple(axes.values()))

    _, cfg = _configs()
    toks = torch.zeros((8, 16), dtype=torch.long)
    pp = stand_in(pp=2, dp=2)
    cases = [
        (NotImplementedError, "sp and pp", lambda: tgpt.forward(
            {}, toks, cfg, mesh=stand_in(pp=2, sp=2))),
        (NotImplementedError, "pp mesh", lambda: tgpt.forward(
            {}, toks, cfg, mesh=pp, return_kv=True)),
        (ValueError, "not divisible by pp=3", lambda: tgpt.forward(
            {}, toks, cfg, mesh=stand_in(pp=3))),
        (ValueError, "batch 6 not divisible by microbatches 4",
         lambda: tgpt.forward({}, toks[:6], cfg, mesh=pp)),
        (NotImplementedError, "attention_mask", lambda: tbert.encode(
            {}, toks, tbert.BERTConfig.tiny(), mesh=pp,
            attention_mask=torch.ones_like(toks))),
        (ValueError, "not divisible by pp=4", lambda: tbert.encode(
            {}, toks, tbert.BERTConfig.tiny(), mesh=stand_in(pp=4))),
        (ValueError, "microbatches >= stages", lambda: train_step_1f1b(
            tgpt.GPTConfig.tiny(pp_microbatches=2), stand_in(pp=4),
            batch_n=8, seq=16)),
        (ValueError, "not divisible by microbatches", lambda: train_step_1f1b(
            tgpt.GPTConfig.tiny(), stand_in(pp=2), batch_n=6, seq=16)),
    ]
    jcfg, _ = _configs()
    for exc, match, call in cases:
        with pytest.raises(exc, match=match):
            call()
    # the JAX package refuses sp with pp in the same words
    with pytest.raises(NotImplementedError, match="sp and pp"):
        jgpt.forward(jgpt.init_params(jcfg, jax.random.PRNGKey(0)),
                     jnp.zeros((8, 16), jnp.int32), jcfg,
                     mesh=jax_mesh_sp_pp())


def jax_mesh_sp_pp():
    from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
    return jcreate_mesh({"pp": 2, "sp": 2}, devices=jax.devices("cpu")[:4])


def test_flash_launches_per_rank_on_pp2_dp2(monkeypatch):
    """Remat "dots", 4 layers over pp2 (2 a stage), M = 4 microbatches
    of 4 rows, 2 per dp rank: T = 5 ticks, so 2 * 5 * 2 = 20 forward and
    5 * 2 = 10 launches of each backward kernel a step on every rank, at
    [2, 2, 32, 16]."""
    _, cfg = _configs(remat=True, remat_policy="dots", attn_impl="flash",
                      attn_block_q=16, attn_block_k=16)
    tree = weights(jgpt.init_params, _configs()[0], 13)
    toks = np.random.default_rng(13).integers(0, 256, (16, 33)).astype(
        np.int32)
    calls: list = []
    for name in ("flash_attention_reference",
                 "flash_attention_backward_reference"):
        fn = getattr(port_flash, name)

        def counted(q, *a, _fn=fn, _name=name, **kw):
            calls.append((threading.current_thread().name, _name,
                          tuple(q.shape)))
            return _fn(q, *a, **kw)
        monkeypatch.setattr(port_flash, name, counted)

    def rank(r):
        mesh = create_mesh({"pp": 2, "dp": 2}, device="cpu")
        params = convert._map(lambda t: t.requires_grad_(True),
                              convert.params_from_numpy(
                                  tree, mesh=mesh,
                                  logical=tgpt.param_logical_axes(cfg)))
        loss = tgpt.loss_fn(params, shard_batch({"tokens": toks}, mesh),
                            cfg, mesh=mesh)
        torch.autograd.grad(loss, convert._leaves(params))

    ranks(rank, 4)
    shape = (2, 2, 32, 16)
    for r in range(4):
        mine = sorted(c[1:] for c in calls if c[0] == f"rank{r}")
        assert mine == sorted(
            [("flash_attention_reference", shape)] * 20
            + [("flash_attention_backward_reference", shape)] * 10), r


# -- 1F1B on pp4.dp2 -------------------------------------------------------------

def _jax_1f1b_pass(params, tokens, cfg, mesh):
    """``ray_tpu/train/step.py`` ``train_step_1f1b``'s step body on given
    params and tokens: (loss, grads)."""
    from jax import lax

    from ray_tpu.parallel.pipeline_1f1b import pipeline_value_and_grads_1f1b
    from ray_tpu.parallel.sharding import DEFAULT_LLM_RULES

    S = mesh.shape["pp"]
    M = cfg.pp_microbatches or 2 * S
    batch_n, seq = tokens.shape[0], tokens.shape[1] - 1
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    body = jgpt._layer_scan_body(cfg, mesh, DEFAULT_LLM_RULES)

    def stage_fn(lp, x):
        (x, _), _ = lax.scan(body, (x, jnp.zeros((), jnp.float32)), lp)
        return x

    def last_fn(tp, x, y):
        logits = jgpt._head(tp, x, cfg, None, DEFAULT_LLM_RULES)
        logz = jax.nn.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, y[..., None], -1)[..., 0]
        return jnp.mean(logz - gold)

    tail_keys = ["ln_f_scale", "ln_f_bias", "wte"]

    @jax.jit
    def step(params):
        eparams = {"wte": params["wte"], "wpe": params["wpe"]}
        tail = {k: params[k] for k in tail_keys}
        x, embed_vjp = jax.vjp(lambda ep: jgpt._embed(
            ep, inp, cfg, None, DEFAULT_LLM_RULES), eparams)
        mb = batch_n // M
        x_mb = x.reshape(M, mb, seq, cfg.d_model)
        y_mb = tgt.reshape(M, mb, seq)
        loss, d_layers, d_tail, d_x = pipeline_value_and_grads_1f1b(
            stage_fn, last_fn, x_mb, y_mb, params["layers"], tail,
            mesh=mesh)
        (d_embed,) = embed_vjp(
            d_x.reshape(batch_n, seq, cfg.d_model).astype(x.dtype))
        return loss, {"layers": d_layers, "wpe": d_embed["wpe"],
                      "ln_f_scale": d_tail["ln_f_scale"],
                      "ln_f_bias": d_tail["ln_f_bias"],
                      "wte": d_embed["wte"] + d_tail["wte"]}

    with mesh:
        return step(params)


def test_1f1b_gpt_pass_on_pp4_dp2_matches_jax():
    kw = dict(vocab_size=512, max_seq=64, d_model=64, n_heads=4, n_layers=4,
              d_ff=128)
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **kw)
    cfg = tgpt.GPTConfig(dtype=torch.float32, **kw)
    tree = weights(jgpt.init_params, jcfg, 14)
    toks = np.random.default_rng(14).integers(0, 512, (16, 33)).astype(
        np.int32)
    jl, jgrads = _jax_1f1b_pass(tree, toks, jcfg, jax_mesh("pp4_dp2"))

    def rank(r):
        mesh = port_mesh("pp4_dp2")
        params = convert.params_from_numpy(
            tree, mesh=mesh, logical=tgpt.param_logical_axes(cfg))
        loss, grads = gpt_value_and_grads_1f1b(
            params, shard_batch({"tokens": toks}, mesh)["tokens"], cfg, mesh)
        out = (loss.to_local().item(), convert.params_to_numpy(grads))
        if r == 0:
            out += (train_step_1f1b(cfg, mesh, batch_n=16, seq=32),)
        else:
            train_step_1f1b(cfg, mesh, batch_n=16, seq=32)
        return out

    got = ranks(rank, world("pp4_dp2"))
    for loss, grads, *_ in got:
        assert abs(loss - float(jl)) < 1e-5, (loss, float(jl))
        for (path, g), w in zip(
                jax.tree_util.tree_leaves_with_path(grads),
                jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                    np.asarray, jgrads))):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))
    assert got[0][2] > 0
