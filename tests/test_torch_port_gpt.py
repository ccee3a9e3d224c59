"""The port's GPT against the JAX package on the CPU, on one set of
weights: ``init_params`` of the JAX package, bridged through numpy.

The config is ``GPTConfig.tiny`` in f32 with ``attn_impl="flash"`` and
64x64 tiles, so the JAX forward runs the Pallas kernel in interpret
mode and the port runs its flash wrapper's plain version.  Logits and
the returned K/V agree within 1e-4; greedy generate is token-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL = 1e-4
FLASH = dict(attn_impl="flash", attn_block_q=64, attn_block_k=64)


@pytest.fixture(scope="module")
def cfgs():
    return (jgpt.GPTConfig.tiny(dtype=jnp.float32, **FLASH),
            tgpt.GPTConfig.tiny(dtype=torch.float32, **FLASH))


@pytest.fixture(scope="module")
def weights(cfgs):
    jparams = jgpt.init_params(cfgs[0], jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, tree, convert.params_from_numpy(tree, device="cpu")


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)) \
        .astype(np.int32)


def test_bridge_round_trip_is_bit_exact(weights):
    _, tree, params = weights
    back = convert.params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == 15
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), path


def test_bridge_recasts_float_leaves(weights):
    _, tree, _ = weights
    half = convert.params_from_numpy(tree, device="cpu",
                                     dtype=torch.bfloat16)
    assert half["layers"]["wqkv"].dtype == torch.bfloat16
    assert half["wte"].shape == tree["wte"].shape


def test_param_layout_matches_jax(cfgs):
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jgpt.init_params(cfgs[0], jax.random.PRNGKey(1)))
    tshapes = {k: ({n: tuple(t.shape) for n, t in v.items()}
                   if isinstance(v, dict) else tuple(v.shape))
               for k, v in tgpt.init_params(cfgs[1], 1,
                                            device="cpu").items()}
    assert jshapes == tshapes
    assert tgpt.PARAM_AXES == jgpt.PARAM_AXES


@pytest.mark.parametrize("seq", [128, 64])
def test_forward_logits_and_kv_match_jax(cfgs, weights, seq):
    jcfg, tcfg = cfgs
    jparams, _, params = weights
    toks = _tokens(seq, 2, seq, jcfg.vocab_size)
    jlogits, (jk, jv) = jgpt.forward(jparams, jnp.asarray(toks), jcfg,
                                     return_kv=True)
    with torch.no_grad():
        logits, (k, v) = tgpt.forward(params, torch.from_numpy(toks).long(),
                                      tcfg, return_kv=True)
    assert logits.dtype == torch.float32
    assert k.shape == (tcfg.n_layers, 2, tcfg.n_heads, seq, tcfg.head_dim)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = jgpt._layer_norm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias))
    got = tgpt._layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x),
                                 approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-5)


def test_sample_token_argmax_ties_break_low():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]])
    assert tgpt.sample_token(logits, temperature=0.0).tolist() == [1, 0]
    np.testing.assert_array_equal(
        np.asarray(jgpt.sample_token(jnp.asarray(logits.numpy()),
                                     temperature=0.0)), [1, 0])
    with pytest.raises(ValueError):
        tgpt.sample_token(logits, temperature=1.0)
    g = torch.Generator().manual_seed(0)
    s = tgpt.sample_token(logits, temperature=1.0, generator=g)
    assert s.shape == (2,) and int(s[0]) in (0, 1, 2, 3)


def test_greedy_generate_is_token_exact(cfgs, weights):
    jcfg, tcfg = cfgs
    jparams, _, params = weights
    prompt = _tokens(9, 2, 5, jcfg.vocab_size)
    want = jgpt.generate(jparams, jcfg, jnp.asarray(prompt), max_new=6,
                         temperature=0.0)
    got = tgpt.generate(params, tcfg, torch.from_numpy(prompt).long(),
                        max_new=6, temperature=0.0)
    assert got.tolist() == np.asarray(want).tolist()


def test_generate_samples_on_its_defaults(cfgs, weights):
    # temperature 1.0 and no generator: a generator seeded with 0, as the
    # JAX package defaults to PRNGKey(0); tokens are not compared with
    # JAX, whose random stream differs by design
    _, tcfg = cfgs
    _, _, params = weights
    prompt = torch.from_numpy(_tokens(11, 2, 5, tcfg.vocab_size)).long()
    got = tgpt.generate(params, tcfg, prompt, 4)
    assert got.shape == (2, 9)
    assert torch.equal(got[:, :5], prompt)
    assert bool(((got[:, 5:] >= 0) & (got[:, 5:] < tcfg.vocab_size)).all())
    assert torch.equal(tgpt.generate(params, tcfg, prompt, 4), got)


def test_moe_config_is_not_ported():
    """An MoE config builds (tests/test_torch_port_moe.py holds it to the
    JAX package); the one MoE path the port leaves out, as the JAX
    package does, is the slot decode step, which raises a
    NotImplementedError when built."""
    from ray_tpu_torch.inference import make_decode_step

    cfg = tgpt.GPTConfig.tiny(n_experts=4)
    with pytest.raises(NotImplementedError):
        make_decode_step(cfg)
