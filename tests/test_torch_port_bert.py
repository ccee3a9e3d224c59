"""The port's BERT against the JAX package on the CPU, ``BERTConfig.tiny``
in f32 (plain attention on both sides: the JAX dispatch takes it off the
TPU, the port's off CUDA).

Parameters are numpy draws in the tree of the JAX package's
``init_params``, bridged through ``params_from_numpy(..., device="cpu")``;
inputs come from numpy seeds, and the JAX references are two jits.

- ``encode`` with and without ``token_type_ids``, and with an
  ``attention_mask`` that pads; ``mlm_logits``, ``pool`` and ``loss_fn``
  with ``ignore_index``; grads, padded and not.
- ``remat=True`` against ``remat=False``.
- A 3-step ``make_train_step`` trajectory with AdamW against optax's,
  and the MLP's likewise.
- a pp mesh raises (the other meshes are held to the JAX package in
  tests/test_torch_port_parallel.py); the init tree and the configs'
  widths are JAX's.

Tolerances, f32: forwards atol = rtol = 1e-5; grads atol = rtol = 1e-4;
the trajectory's loss and grad_norm rel 1e-4 at every step, its params
atol 1e-4 after (Adam turns the f32 noise of a near-zero gradient into
a step of up to lr = 1e-3; the largest difference seen was 5.3e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_trees import (FWD, GRAD, assert_same_layout,
                               assert_trees_close, bridge, grad_tree,
                               jax_shapes, requiring_grad, to_numpy, weights)
from ray_tpu.models import bert as jbert
from ray_tpu.models import mlp as jmlp
from ray_tpu.train.step import make_train_step as jmake_train_step
from ray_tpu_torch.models import bert as tbert
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import mlp as tmlp
from ray_tpu_torch.train import adamw, make_train_step

BERT_B, BERT_S = 2, 32


@pytest.fixture(scope="module")
def bert_case():
    """tiny BERT params and a batch: 15% of positions labelled (the rest
    ignore_index), token types, and a mask padding the last 8 positions
    of row 1; JAX's encodes and heads in one jit, its losses and grads in
    another (a third faster to compile than one jit of both)."""
    jcfg = jbert.BERTConfig.tiny()
    tree = weights(jbert.init_params, jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (BERT_B, BERT_S)).astype(np.int32)
    labels = np.where(rng.random((BERT_B, BERT_S)) < 0.15, ids,
                      jcfg.ignore_index).astype(np.int32)
    labels[:, 0] = ids[:, 0]              # at least one label per row
    mask = np.ones((BERT_B, BERT_S), np.int32)
    mask[1, -8:] = 0
    types = (np.arange(BERT_S)[None, :] >= BERT_S // 2).astype(np.int32) \
        .repeat(BERT_B, axis=0)
    batch = {"input_ids": ids, "labels": labels, "attention_mask": mask,
             "token_type_ids": types}

    def forwards(p, b):
        hidden = jbert.encode(p, b["input_ids"], jcfg)
        return dict(
            hidden=hidden,
            typed=jbert.encode(p, b["input_ids"], jcfg,
                               token_type_ids=b["token_type_ids"]),
            masked=jbert.encode(p, b["input_ids"], jcfg,
                                attention_mask=b["attention_mask"]),
            mlm=jbert.mlm_logits(p, hidden, jcfg),
            pooled=jbert.pool(p, hidden))

    def grads(p, b):
        plain = {"input_ids": b["input_ids"], "labels": b["labels"]}
        loss, g = jax.value_and_grad(jbert.loss_fn)(p, plain, jcfg)
        mloss, mg = jax.value_and_grad(jbert.loss_fn)(p, b, jcfg)
        return dict(loss=loss, grads=g, masked_loss=mloss, masked_grads=mg)

    want = {**jax.jit(forwards)(tree, batch), **jax.jit(grads)(tree, batch)}
    return tree, batch, to_numpy(want)


def _torch_batch(batch, *keys):
    return {k: torch.from_numpy(batch[k]) for k in keys}


def test_bert_encode_and_heads_match_jax(bert_case):
    tree, batch, want = bert_case
    cfg = tbert.BERTConfig.tiny()
    params = bridge(tree)
    tb = _torch_batch(batch, *batch)
    with torch.no_grad():
        hidden = tbert.encode(params, tb["input_ids"], cfg)
        typed = tbert.encode(params, tb["input_ids"], cfg,
                             token_type_ids=tb["token_type_ids"])
        masked = tbert.encode(params, tb["input_ids"], cfg,
                              attention_mask=tb["attention_mask"])
        mlm = tbert.mlm_logits(params, hidden, cfg)
        pooled = tbert.pool(params, hidden)
    assert hidden.shape == (BERT_B, BERT_S, cfg.d_model)
    assert mlm.dtype == torch.float32
    for name, got in (("hidden", hidden), ("typed", typed),
                      ("masked", masked), ("mlm", mlm), ("pooled", pooled)):
        np.testing.assert_allclose(got.numpy(), want[name], **FWD,
                                   err_msg=name)
    # the mask really pads: row 1 differs from the unmasked encode, row 0
    # (all ones) does not
    assert not np.allclose(masked[1].numpy(), hidden[1].numpy(), atol=1e-3)
    np.testing.assert_allclose(masked[0].numpy(), hidden[0].numpy(), **FWD)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_bert_loss_and_grads_match_jax(bert_case, masked):
    tree, batch, want = bert_case
    cfg = tbert.BERTConfig.tiny()
    keys = ("input_ids", "labels") + (
        ("attention_mask", "token_type_ids") if masked else ())
    params = requiring_grad(tree)
    loss = tbert.loss_fn(params, _torch_batch(batch, *keys), cfg)
    prefix = "masked_" if masked else ""
    np.testing.assert_allclose(loss.item(), want[prefix + "loss"], **FWD)
    assert_trees_close(grad_tree(loss, params), want[prefix + "grads"],
                        **GRAD)


def test_bert_loss_ignores_unlabelled_positions(bert_case):
    """The loss is the mean NLL over labelled positions only, and a batch
    without labels gives 0 (the mean over max(#valid, 1)), not NaN."""
    tree, batch, _ = bert_case
    cfg = tbert.BERTConfig.tiny()
    params = bridge(tree)
    tb = _torch_batch(batch, "input_ids", "labels")
    with torch.no_grad():
        loss = tbert.loss_fn(params, tb, cfg)
        logits = tbert.mlm_logits(
            params, tbert.encode(params, tb["input_ids"], cfg), cfg)
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, cfg.vocab_size), tb["labels"].reshape(-1).long(),
            ignore_index=cfg.ignore_index)
        none = tbert.loss_fn(params, {**tb, "labels": torch.full_like(
            tb["labels"], cfg.ignore_index)}, cfg)
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)
    assert none.item() == 0.0


def test_bert_all_ones_mask_equals_no_mask(bert_case):
    """The JAX package's check (tests/test_models.py): an all-ones
    attention_mask (plain attention) gives the unmasked loss."""
    tree, batch, want = bert_case
    cfg = tbert.BERTConfig.tiny()
    params = bridge(tree)
    tb = _torch_batch(batch, "input_ids", "labels")
    with torch.no_grad():
        ones = tbert.loss_fn(params, {**tb, "attention_mask": torch.ones_like(
            tb["input_ids"])}, cfg)
    np.testing.assert_allclose(ones.item(), want["loss"], rtol=1e-5)


def test_bert_remat_matches_no_remat(bert_case):
    tree, batch, _ = bert_case
    tb = _torch_batch(batch, "input_ids", "labels")
    out = []
    for remat in (False, True):
        cfg = tbert.BERTConfig.tiny(remat=remat)
        params = requiring_grad(tree)
        loss = tbert.loss_fn(params, tb, cfg)
        out.append((loss.item(), grad_tree(loss, params)))
    assert out[0][0] == pytest.approx(out[1][0], abs=1e-6)
    assert_trees_close(out[1][1], out[0][1], atol=1e-6, rtol=0)


def test_bert_train_step_trajectory_matches_optax(bert_case):
    """Three make_train_step steps of AdamW(1e-3, weight_decay=0.01) on
    one repeated batch: loss and grad_norm at every step, params after."""
    tree, batch, _ = bert_case
    jcfg, cfg = jbert.BERTConfig.tiny(), tbert.BERTConfig.tiny()
    keys = ("input_ids", "labels")
    j_init, j_step = jmake_train_step(
        functools.partial(jbert.loss_fn, cfg=jcfg),
        optax.adamw(1e-3, weight_decay=0.01))
    jstate = j_init(jax.tree_util.tree_map(jnp.asarray, tree))
    jbatch = {k: jnp.asarray(batch[k]) for k in keys}
    t_init, t_step = make_train_step(
        lambda p, b: tbert.loss_fn(p, b, cfg),
        adamw(1e-3, weight_decay=0.01))
    state = t_init(bridge(tree))
    tb = _torch_batch(batch, *keys)
    for i in range(3):
        jstate, jm = j_step(jstate, jbatch)
        state, m = t_step(state, tb)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"step {i} {key}")
    assert_trees_close(convert.params_to_numpy(state.params),
                        to_numpy(jstate.params), atol=1e-4, rtol=0)


def test_mlp_train_step_trajectory_matches_optax():
    """The MLP trains through make_train_step as BERT does (here, where
    the JAX step is already compiled for): three steps of AdamW(1e-3) on
    one batch, loss and grad_norm at each step (rel 1e-4), the params
    after (atol 1e-5)."""
    kw = dict(in_dim=64, hidden=(32, 32), out_dim=10)
    jcfg, cfg = jmlp.MLPConfig(**kw), tmlp.MLPConfig(**kw)
    tree = weights(jmlp.init_params, jcfg)
    rng = np.random.default_rng(1)
    batch = {"x": rng.standard_normal((16, 64)).astype(np.float32),
             "y": rng.integers(0, 10, 16).astype(np.int32)}
    j_init, j_step = jmake_train_step(
        functools.partial(jmlp.loss_fn, cfg=jcfg), optax.adamw(1e-3))
    jstate = j_init(jax.tree_util.tree_map(jnp.asarray, tree))
    t_init, t_step = make_train_step(
        functools.partial(tmlp.loss_fn, cfg=cfg), adamw(1e-3))
    state = t_init(bridge(tree))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        jstate, jm = j_step(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        state, m = t_step(state, tb)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]),
                                       rtol=1e-4, err_msg=f"step {i} {key}")
    assert_trees_close(convert.params_to_numpy(state.params),
                       to_numpy(jstate.params), atol=1e-5, rtol=0)


def test_bert_refuses_a_mesh(bert_case):
    """The pipelined encoder is ported (tests/
    test_torch_port_pipeline_gpt.py); an ``attention_mask`` on a pp mesh
    raises before any collective, as the JAX package refuses it; the mesh
    stands in with its axis names and sizes."""
    from types import SimpleNamespace

    tree, batch, _ = bert_case
    cfg = tbert.BERTConfig.tiny()
    ids = torch.from_numpy(batch["input_ids"])
    pp_mesh = SimpleNamespace(mesh_dim_names=("pp", "dp"), shape=(2, 2))
    with pytest.raises(NotImplementedError, match="attention_mask"):
        tbert.encode(bridge(tree), ids, cfg, mesh=pp_mesh,
                     attention_mask=torch.ones_like(ids))


def test_init_tree_and_widths_are_jax_s():
    got = tbert.init_params(tbert.BERTConfig.tiny(), device="cpu")
    want = jax_shapes(jbert.init_params, jbert.BERTConfig.tiny())
    assert_same_layout(got, want)
    assert tbert.num_params(got) == jbert.num_params(want)
    assert (tbert.param_logical_axes(tbert.BERTConfig.tiny())
            == jbert.param_logical_axes(jbert.BERTConfig.tiny()))
    for name in ("bert_base", "tiny"):
        j, t = getattr(jbert.BERTConfig, name)(), \
            getattr(tbert.BERTConfig, name)()
        for field in ("vocab_size", "max_seq", "type_vocab", "d_model",
                      "n_heads", "n_layers", "d_ff", "remat", "ignore_index",
                      "attn_impl"):
            assert getattr(j, field) == getattr(t, field), (name, field)
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
