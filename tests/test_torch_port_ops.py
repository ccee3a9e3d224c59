"""The port's attention ops against the JAX package on the CPU.

The same numpy inputs (from a seed) go through ``ray_tpu.ops`` (the
Pallas flash kernel in interpret mode, the plain reference, the paged
gather) and through ``ray_tpu_torch.ops``.  Tolerance: atol/rtol 2e-4 in
f32, the CPU bound of tests/test_ops.py.  Also: the import boundary of
the port, and that its entry points refuse to run without a card unless
asked for the CPU."""

import ast
import importlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages re-export functions under their modules' names, so the
# modules themselves come from importlib
jax_attention = importlib.import_module("ray_tpu.ops.attention")
jax_flash = importlib.import_module("ray_tpu.ops.flash_attention")
port_attention = importlib.import_module("ray_tpu_torch.ops.attention")
port_flash = importlib.import_module("ray_tpu_torch.ops.flash_attention")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=2e-4, rtol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(seed, b, h, sq, skv, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d)))


# (b, h, q_len, kv_len, block_q, block_k): test_ops.py's shapes
FLASH_CASES = [
    (2, 4, 256, 256, 128, 128),    # square, block-aligned
    (1, 2, 128, 384, 128, 128),    # cross-length: q at the tail of kv
    (1, 2, 64, 128, 32, 32),       # cross-length, small tiles
    (1, 2, 200, 200, 128, 128),    # ragged kv (200 % 128)
    (1, 1, 96, 96, 32, 64),        # ragged kv (96 % 64)
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "q{}kv{}b{}x{}".format(*c[2:]))
def test_flash_reference_matches_pallas(case, causal):
    b, h, sq, skv, bq, bk = case
    q, k, v = _qkv(1, b, h, sq, skv)
    want = jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     block_q=bq, block_k=bk)
    got = port_flash.flash_attention(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_lse_matches_pallas(causal):
    q, k, v = _qkv(2, 1, 2, 256, 256)
    want_o, want_lse = jax_flash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128)
    got_o, got_lse = port_flash.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=128, block_k=128)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    # the Pallas lse is [bh, sq, 128] broadcast over lanes; the port's
    # is [b, h, sq]
    lanes = np.asarray(want_lse)
    np.testing.assert_allclose(got_lse.numpy(),
                               lanes[..., 0].reshape(1, 2, 256), **TOL)


def test_flash_reference_is_differentiable_on_cpu():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(3, 1, 1, 64, 64))
    port_flash.flash_attention(q, k, v, block_q=32, block_k=32).sum() \
        .backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("kind", ["causal", "cross", "kv_lengths", "mask"])
def test_mha_reference_matches_jax(kind):
    b, h, sq, skv = 2, 2, 32, 48
    q, k, v = _qkv(4, b, h, sq if kind != "causal" else skv, skv, d=16)
    rng = np.random.default_rng(5)
    kw_j, kw_t = {}, {}
    causal = kind in ("causal", "cross")
    if kind == "kv_lengths":
        lens = np.asarray([17, 48], np.int32)
        kw_j["kv_lengths"] = jnp.asarray(lens)
        kw_t["kv_lengths"] = torch.from_numpy(lens.astype(np.int64))
    if kind == "mask":
        m = rng.random((b, 1, sq, skv)) < 0.7
        m[..., 0] = True                      # every row keeps a key
        kw_j["mask"] = jnp.asarray(m)
        kw_t["mask"] = torch.from_numpy(m)
    want = jax_attention.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal, **kw_j)
    got = port_attention.mha_reference(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal,
                                       **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_mask", [False, True])
def test_paged_attention_matches_jax(use_mask):
    rng = np.random.default_rng(6)
    n_blocks, h, bs, hd, b, T = 9, 2, 4, 16, 3, 4
    k_pool = rng.standard_normal((n_blocks, h, bs, hd)).astype(np.float32)
    v_pool = rng.standard_normal((n_blocks, h, bs, hd)).astype(np.float32)
    tables = rng.integers(0, n_blocks, (b, T)).astype(np.int32)
    q_len = 3 if use_mask else 1
    q = rng.standard_normal((b, h, q_len, hd)).astype(np.float32)
    lens = np.asarray([5, 16, 9], np.int32)
    kw_j = dict(kv_lengths=jnp.asarray(lens))
    kw_t = dict(kv_lengths=torch.from_numpy(lens.astype(np.int64)))
    if use_mask:
        m = (np.arange(T * bs)[None, :]
             <= np.asarray([4, 9, 13])[:, None])[None, None]
        kw_j["mask"] = jnp.asarray(m)
        kw_t["mask"] = torch.from_numpy(m)
    want = jax_attention.paged_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), **kw_j)
    got = port_attention.paged_attention(
        torch.from_numpy(q), torch.from_numpy(k_pool),
        torch.from_numpy(v_pool), torch.from_numpy(tables.astype(np.int64)),
        **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_dispatch_on_cpu_takes_reference():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 1, 2, 128, 128))
    before = port_flash.launches
    out = port_attention.attention(q, k, v, causal=True)
    assert port_flash.launches == before
    np.testing.assert_allclose(
        out.numpy(), port_attention.mha_reference(q, k, v).numpy(), **TOL)
    with pytest.raises(ValueError):
        port_attention.attention(q, k, v, mask=torch.ones(1, 1, 128, 128,
                                                          dtype=torch.bool),
                                 impl="flash")


# ------------------------------------------------------ package boundary

def _port_sources():
    root = os.path.join(REPO, "ray_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_neither_jax_nor_ray_tpu(path):
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
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ray_tpu"), \
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"


def test_device_none_raises_without_a_card(monkeypatch):
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.inference import BlockPool, GPTServer, InferenceEngine
    from ray_tpu_torch.models import convert, gpt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt.GPTConfig.tiny(dtype=torch.float32)
    for call in (lambda: resolve_device(None),
                 lambda: gpt.init_params(cfg, 0),
                 lambda: convert.params_from_numpy({"a": np.zeros(2)}),
                 lambda: BlockPool(cfg, 8, 16),
                 lambda: InferenceEngine(
                     gpt.init_params(cfg, 0, device="cpu"), cfg),
                 lambda: GPTServer(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_cp_async_alignment_helper():
    # the bf16 forward kernel's 16-byte copies read the model's q, k, v
    # (strided views split from one qkv projection) in place
    b, s, h, hd = 2, 16, 2, 64
    qkv = torch.zeros((b, s, 3 * h * hd), dtype=torch.bfloat16)
    views = [t.reshape(b, s, h, hd).transpose(1, 2)
             for t in qkv.split(h * hd, dim=-1)]
    assert all(port_flash._cp_async_aligned(t) for t in views)
    assert all(port_flash._aligned(*views)[i] is views[i] for i in range(3))
    # a contiguous view at a 1-element offset is not 16-byte aligned
    flat = torch.zeros(b * h * s * hd + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(b, h, s, hd)
    assert shifted.is_contiguous()
    assert not port_flash._cp_async_aligned(shifted)
    copied = port_flash._aligned(shifted)[0]
    assert port_flash._cp_async_aligned(copied)
    assert torch.equal(copied, shifted)
    # a row stride that is not a whole number of 16-byte chunks
    wide = torch.zeros((b, h, s, hd + 4), dtype=torch.bfloat16)[..., :hd]
    assert wide.stride(2) == hd + 4
    assert not port_flash._cp_async_aligned(wide)


def test_cp_async_alignment_helper_f32():
    # the f32 forward kernel's 16-byte copies take 4 f32 elements a chunk:
    # a 16-byte base and strides in multiples of 4 elements pass as they are
    b, s, h, hd = 2, 16, 2, 64
    qkv = torch.arange(b * s * 3 * h * hd, dtype=torch.float32).reshape(
        b, s, 3 * h * hd)
    views = [t.reshape(b, s, h, hd).transpose(1, 2)
             for t in qkv.split(h * hd, dim=-1)]
    assert all(port_flash._cp_async_aligned(t) for t in views)
    assert all(port_flash._aligned(*views)[i] is views[i] for i in range(3))
    padded4 = torch.zeros((b, h, s, hd + 4))[..., :hd]
    assert port_flash._cp_async_aligned(padded4)
    # a 1-element offset is 4 bytes off: copied, and the copy equals it
    flat = torch.arange(b * h * s * hd + 1, dtype=torch.float32)
    shifted = flat[1:].view(b, h, s, hd)
    assert shifted.is_contiguous()
    assert not port_flash._cp_async_aligned(shifted)
    copied = port_flash._aligned(shifted)[0]
    assert copied is not shifted and port_flash._cp_async_aligned(copied)
    assert torch.equal(copied, shifted)
    # a row stride padded by 2 elements (8 bytes) is not whole chunks
    wide = torch.arange(b * h * s * (hd + 2), dtype=torch.float32).reshape(
        b, h, s, hd + 2)[..., :hd]
    assert wide.stride(2) == hd + 2
    assert not port_flash._cp_async_aligned(wide)
    copied = port_flash._aligned(wide)[0]
    assert port_flash._cp_async_aligned(copied)
    assert torch.equal(copied, wide)


def test_kernel_libraries_rebuild_when_the_shared_header_changes(
        tmp_path, monkeypatch):
    # both kernels include csrc/tc.cuh: a library named by its source's
    # hash alone would be loaded stale after an edit to the header
    from ray_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {n: _build._target(n)[1] for n in ("flash_fwd", "flash_bwd")}
    assert before == {n: _build._target(n)[1] for n in before}
    header = csrc / "tc.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = {n: _build._target(n)[1] for n in before}
    assert all(after[n] != before[n] for n in before)


def test_flash_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, 1, 1, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        port_flash._launch(q, k, v, 0.125, True, False)


def test_ops_export_every_name_the_jax_ops_export():
    import ray_tpu.ops as jops
    import ray_tpu_torch.ops as tops
    assert set(jops.__all__) <= set(tops.__all__)
    ring = importlib.import_module("ray_tpu_torch.ops.ring_attention")
    assert tops.ring_attention is ring.ring_attention
