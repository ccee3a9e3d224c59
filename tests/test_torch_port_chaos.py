"""The port engine's fault-plane and flight-recorder hooks against the JAX
engine's, on the CPU, on ``GPTConfig.tiny`` in f32 with ``max_seq=64``
and one set of weights (JAX's ``init_params`` bridged through numpy).

The JAX package's own ``FaultPlan``/``Rule`` and ``FlightRecorder`` are
installed into the port's gates (``ray_tpu_torch.core``), and the same
plan then runs on the JAX engine.  The scenarios are those of
tests/test_paged_cache.py (a block-allocation failure at decode-time
growth) and tests/test_speculative.py (forced full rejection, a raising
speculation hook, ``engine_request`` events and their timeline slices),
plus the ``infer_admit`` ctx.  Both engines must log the same points,
stream the same tokens (equal to JAX's ``gpt.generate``), recover the
same way without leaking a block, and note the same events apart from
their times."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core import fault_injection as jfi
from ray_tpu.core import flight_recorder as jfr
from ray_tpu.inference import EngineConfig as JEngineConfig
from ray_tpu.inference import InferenceEngine as JInferenceEngine
from ray_tpu.models import gpt as jgpt
from ray_tpu.util.timeline import build_trace
from ray_tpu_torch.core import fault_injection as tfi
from ray_tpu_torch.core import flight_recorder as tfr
from ray_tpu_torch.inference import EngineConfig, InferenceEngine
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt

JCFG = jgpt.GPTConfig.tiny(dtype=jnp.float32, max_seq=64)
TCFG = tgpt.GPTConfig.tiny(dtype=torch.float32, max_seq=64)
REP = [1, 2, 3, 4] * 6                    # the n-gram drafter's gold
ALLOC = dict(max_slots=2, kv_block_size=4, prefill_chunk=16)
SPEC = dict(max_slots=4, kv_block_size=8, prefill_chunk=16,
            speculate="ngram", speculate_k=4)
_jax_generate = jax.jit(jgpt.generate,
                        static_argnames=("cfg", "max_new", "temperature"))


@pytest.fixture(scope="module")
def model():
    jparams = jgpt.init_params(JCFG, jax.random.PRNGKey(0))
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, params


@pytest.fixture(autouse=True)
def _gates_clear():
    yield
    tfi.uninstall()
    tfr.disable()
    jfi.uninstall()
    jfr.disable()


def _ref_tokens(jparams, prompt, max_new):
    out = _jax_generate(jparams, JCFG, jnp.asarray([prompt], jnp.int32),
                        max_new=max_new, temperature=0.0)
    return np.asarray(out)[0, len(prompt):].tolist()


def _engines(model, ec: dict):
    """(port engine, JAX engine) over the same weights, one name."""
    jparams, params = model
    return (InferenceEngine(params, TCFG, EngineConfig(**ec), device="cpu",
                            name="chaos"),
            JInferenceEngine(jparams, JCFG, JEngineConfig(**ec),
                             name="chaos"))


def _run_both(model, ec: dict, plan_fn, scenario, after=None):
    """Run ``scenario(engine)`` on the port engine under a plan installed
    in the port's gate, then on the JAX engine under a fresh plan in the
    JAX package's gate; ``after(engine)`` runs once the plan is gone.
    Returns [(plan, scenario result, after result, stats after)] for the
    port and JAX, each engine shut down."""
    out = []
    for eng, gate in zip(_engines(model, ec), (tfi, jfi)):
        plan = plan_fn()
        try:
            with gate.injected(plan):
                res = scenario(eng)
            later = after(eng) if after is not None else None
            out.append((plan, res, later, eng.stats()))
        finally:
            eng.shutdown()
    return out


def _points(plan) -> list:
    return [p for p, _, _ in plan.log]


def _assert_no_block_leak(st):
    assert st["blocks_free"] + st["prefix_cached_blocks"] \
        == st["blocks_total"], f"block leak: {st}"


def test_gates_are_one_global_and_scoped():
    """Unarmed, both gates read None; ``injected`` installs for its block
    only; ``enable`` is idempotent; the port's recorder keeps what the
    engine notes."""
    assert tfi.active() is None and tfr.active() is None
    plan = object()
    with tfi.injected(plan) as got:
        assert got is plan and tfi.active() is plan and tfi._active is plan
    assert tfi.active() is None
    rec = tfr.enable(keep_ingress=2)
    assert tfr.enable() is rec and tfr.active() is rec
    for i in range(3):
        rec.note_ingress({"kind": "engine_request", "req": i})
    assert [e["req"] for e in rec.export_ingress()] == [1, 2]
    tfr.disable()
    assert tfr.active() is None


def test_chaos_block_alloc_failure_recovers(model):
    """tests/test_paged_cache.py's infer_block_alloc scenario: the 2nd
    decode-time block allocation raises; the in-flight request fails with
    the injected error, the pool is reset (its generation bumped), and
    the next request is token-exact with no leak."""
    jparams, _ = model

    def plan_fn():
        plan = jfi.FaultPlan()

        def raiser(ctx):
            raise RuntimeError("injected block-alloc failure")

        plan.add(jfi.Rule("infer_block_alloc", "script", fn=raiser, nth=2))
        return plan

    def scenario(eng):
        bad = eng.submit([1, 2, 3, 4, 5], max_new=12)   # crosses blocks
        with pytest.raises(RuntimeError, match="injected block-alloc"):
            bad.result(timeout=60)
        gen = eng.pool.generation
        return bad.tokens, gen

    (tplan, (ttoks, tgen), tout, tst), (jplan, (jtoks, jgen), jout, jst) = \
        _run_both(model, ALLOC, plan_fn, scenario,
                  lambda eng: eng.generate([6, 7, 8], max_new=4,
                                           timeout=120))
    assert _points(tplan) == _points(jplan) == ["infer_block_alloc"]
    assert ttoks == jtoks                    # emitted before the failure
    assert tgen == jgen == 1
    # the engines keep serving once the plans are gone
    assert tout == jout == _ref_tokens(jparams, [6, 7, 8], 4)
    _assert_no_block_leak(tst)
    _assert_no_block_leak(jst)


def test_chaos_forced_rejection_keeps_parity_and_blocks(model):
    """tests/test_speculative.py: ``reject_all`` on every infer_speculate
    pass; the verify pass still runs, every draft is rejected, the
    stream stays token-exact and the rollback leaks no block."""
    jparams, _ = model

    def plan_fn():
        plan = jfi.FaultPlan()
        plan.add(jfi.Rule("infer_speculate", "script",
                          fn=lambda ctx: ctx.__setitem__("reject_all", True)))
        return plan

    (tplan, tout, _, tst), (jplan, jout, _, jst) = _run_both(
        model, SPEC, plan_fn,
        lambda eng: eng.generate(REP, max_new=8, timeout=120))
    assert tout == jout == _ref_tokens(jparams, REP, 8)
    assert _points(tplan) == _points(jplan)
    assert "infer_speculate" in _points(tplan)
    for st in (tst, jst):
        assert st["spec_drafted_tokens"] > 0
        assert st["spec_accepted_tokens"] == 0
        assert st["spec_accept_rate"] == 0.0
        _assert_no_block_leak(st)
    assert tst["spec_drafted_tokens"] == jst["spec_drafted_tokens"]


def test_chaos_speculate_raise_takes_recovery_path(model):
    """A raising infer_speculate hook fails the in-flight request with
    the injected error; the engine keeps serving token-exact."""
    jparams, _ = model

    def plan_fn():
        plan = jfi.FaultPlan()

        def raiser(ctx):
            raise RuntimeError("injected speculation failure")

        plan.add(jfi.Rule("infer_speculate", "script", fn=raiser, nth=1))
        return plan

    def scenario(eng):
        bad = eng.submit(REP, max_new=8)
        with pytest.raises(RuntimeError, match="injected speculation"):
            bad.result(timeout=60)
        return bad.tokens

    (tplan, ttoks, tout, tst), (jplan, jtoks, jout, _) = _run_both(
        model, SPEC, plan_fn, scenario,
        lambda eng: eng.generate(REP, max_new=4, timeout=120))
    assert _points(tplan) == _points(jplan) == ["infer_speculate"]
    assert ttoks == jtoks
    assert tout == jout == _ref_tokens(jparams, REP, 4)
    _assert_no_block_leak(tst)


def test_infer_admit_ctx_matches_jax(model):
    """The infer_admit ctx carries the engine's name, the request id, the
    blocks it needs and its prefix hit; a second prompt sharing a
    two-block head is admitted with the hit credited."""
    head = list(range(10, 26))                # two blocks of 8

    def plan_fn():
        plan = jfi.FaultPlan()
        plan.seen = []
        plan.add(jfi.Rule("infer_admit", "script",
                          fn=lambda ctx: plan.seen.append(dict(ctx))))
        return plan

    def scenario(eng):
        eng.generate(head + [1, 2], max_new=2, timeout=120)
        eng.generate(head + [3, 4], max_new=2, timeout=120)

    (tplan, _, _, _), (jplan, _, _, _) = _run_both(
        model, dict(SPEC, speculate=None), plan_fn, scenario)
    assert tplan.seen == jplan.seen
    assert tplan.seen == [
        {"engine": "chaos", "req": 0, "need": 3, "hit_tokens": 0},
        {"engine": "chaos", "req": 1, "need": 1, "hit_tokens": 16}]


def test_engine_request_events_match_jax_and_render(model):
    """With the JAX package's recorder armed in the port's gate, every
    finished request notes one ``engine_request`` event; its fields equal
    the JAX engine's apart from the times, its ``spec_accepted`` counts
    sum to the engine's accepted tokens, and the JAX timeline renders the
    port's events as engine slices."""
    jparams, params = model
    prompts = [REP, [5, 6, 7, 8] * 4, [9, 3, 1]]
    events = []
    for eng, gate in zip(_engines(model, SPEC), (tfr, jfr)):
        rec = jfr.FlightRecorder()
        gate._active = rec
        try:
            for h in [eng.submit(p, max_new=6) for p in prompts]:
                h.result(timeout=120)
            accepted = eng.stats()["spec_accepted_tokens"]
        finally:
            gate._active = None
            eng.shutdown()
        evs = [e for e in rec.export_ingress()
               if e.get("kind") == "engine_request"]
        assert len(evs) == len(prompts)
        assert sum(e["spec_accepted"] for e in evs) == accepted
        assert all(e["t"] >= e["start_t"] for e in evs)
        events.append(evs)
    untimed = [sorted(({k: v for k, v in e.items()
                        if k not in ("t", "start_t")} for e in evs),
                      key=lambda e: e["req"]) for evs in events]
    assert untimed[0] == untimed[1]
    assert {e["tokens"] for e in untimed[0]} == {6}
    assert sum(e["spec_accepted"] for e in untimed[0]) > 0
    trace = build_trace(ingress=events[0])
    sl = [e for e in trace["traceEvents"] if e.get("cat") == "engine"]
    assert len(sl) == len(prompts)
    assert all(e["ph"] == "X" and e["pid"] == "engine"
               and e["tid"] == "chaos" for e in sl)
    assert sorted(e["args"]["req"] for e in sl) == [0, 1, 2]
