"""The port's slot engine (``EngineConfig(paged=False)``) on a tp mesh
against the JAX package's slot engine on the same mesh, on the CPU:
``GPTConfig.tiny`` in f32 with ``max_seq=64``, JAX's ``init_params``
bridged through numpy; the port's tp ranks are threads of this process,
the JAX engine runs on a {tp: n} mesh of conftest's CPU devices.

- on tp2 and tp4, prompts of several lengths and more requests than
  slots (slots are reused): every greedy reply equals the JAX slot
  engine's on the same mesh and the port's ``generate``; no slot is
  left allocated, and every rank holds its heads of the stripes a
  one-device slot engine holds after the same traffic (1e-5);
``GPTServer`` on the slot engine, the slot cache and the dense step on
tp ranks, and the failures are ``tests/test_torch_port_tp_slot_serve.py``
(one file each keeps both within their time).  No subprocess, no
sleep."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.inference import EngineConfig as JEngineConfig
from ray_tpu.inference import InferenceEngine as JInferenceEngine
from ray_tpu.models import gpt as jgpt
from ray_tpu.parallel.mesh import create_mesh as jcreate_mesh
from ray_tpu_torch.inference import EngineConfig, InferenceEngine, tp
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
SLOT = dict(paged=False, max_slots=2)
# several lengths, more requests than the two slots
PROMPTS = [[3, 1, 4, 1, 5], list(range(200, 240)), [7], [5, 6, 7] * 4,
           list(range(60, 77))]
MAX_NEW = 8


@pytest.fixture(scope="module")
def model():
    jparams = jax.jit(jgpt.init_params, static_argnums=0)(
        JCFG, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    want = [tgpt.generate(params, TCFG, torch.tensor([p]), MAX_NEW,
                          temperature=0.0)[0, len(p):].tolist()
            for p in PROMPTS]
    return jparams, params, want


@pytest.fixture(autouse=True)
def _no_executor_left():
    yield
    assert tp._executor is None, "a test left its tp executor running"


def _port(params, n, **ec):
    return InferenceEngine(params, TCFG, EngineConfig(**{**SLOT, **ec}),
                           device="cpu", name="slot", mesh={"tp": n})


def _serve(eng):
    """The replies to ``PROMPTS``, submitted one after another (so each
    admission takes the same slot on every engine)."""
    return [eng.generate(p, max_new=MAX_NEW, timeout=120) for p in PROMPTS]


@pytest.mark.parametrize("n", [2, 4])
def test_slot_engine_on_tp_matches_the_jax_slot_engine(model, n):
    jparams, params, want = model

    def jax_side():
        jeng = JInferenceEngine(jparams, JCFG, JEngineConfig(**SLOT),
                                mesh=jcreate_mesh(
                                    {"tp": n},
                                    devices=jax.devices("cpu")[:n]))
        try:
            return _serve(jeng)
        finally:
            jeng.shutdown()

    one = InferenceEngine(params, TCFG, EngineConfig(**SLOT), device="cpu")
    eng = _port(params, n)
    # JAX compiles its engine's steps on its own thread meanwhile
    with ThreadPoolExecutor(1) as ex:
        jrun = ex.submit(jax_side)
        try:
            got, one_got = _serve(eng), _serve(one)
            k, v = eng.cache.read_slots([0, 1])
            ok, ov = one.cache.read_slots([0, 1])
            hs = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
            together = [h.result(timeout=120) for h in hs]
            st = eng.stats()
            shards = eng._ranks.executor.on_ranks(
                lambda ctx: tuple(ctx.engines["slot"].pool.kv.shape))
        finally:
            eng.shutdown()
            one.shutdown()
        jgot = jrun.result()
    assert got == jgot == want == one_got == together
    assert st["free_slots"] == 2 and st["active_slots"] == 0
    assert st["requests_completed"] == 2 * len(PROMPTS)
    assert st["mesh_devices"] == st["tp_shards"] == n
    assert st["full_prefills"] == 2 * len(PROMPTS)
    assert shards == [(2, TCFG.n_layers, 2, TCFG.n_heads // n, 64,
                       TCFG.head_dim)] * n
    np.testing.assert_allclose(k, ok, atol=1e-5, rtol=0)
    np.testing.assert_allclose(v, ov, atol=1e-5, rtol=0)
