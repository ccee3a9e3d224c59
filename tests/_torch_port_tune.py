"""Glue that runs the port under the JAX package's unchanged
``ray_tpu.tune``, and the pieces the tune tests share.  Not a test
module; imported only by ``tests/test_torch_port_tune_*.py``.

- ``port_trainable(algo_cls)``: a ``ray_tpu.tune.Trainable`` holding one
  port algorithm built on the CPU; ``train``, ``save``, ``restore``,
  ``cleanup``, ``reset_config`` and ``iteration`` are the algorithm's,
  so the tuner's iteration and the one in the algorithm's saves are one
  number.  Every result and save that passes through it is checked to
  hold no ``torch.Tensor`` (the tuner pickles them into its experiment
  state, which must load without a card).  Each save and restore is
  logged on the class (``saves``, ``restores``) for the tests.
- ``fail_once(cls)``: ``cls`` raising once, at the iteration its config's
  ``fail_at`` names, the first time any trial claims the marker file
  ``fail_marker``.
- ``RecordingPBT``: PBT that records every result it decides on, the
  scores at every perturbation point and every exploit as (iteration,
  source, target, new config).
- ``port_gpt_train_fn`` / ``jax_gpt_train_fn``: function trainables of
  ``GPTConfig.tiny`` (f32, plain attention) under AdamW(lr, weight
  decay 0.1), from the same numpy weights on the same fixed batches;
  each reports its loss with the state as its checkpoint every step and
  resumes from ``tune.get_checkpoint()``; ``lockstep(fn)`` keeps its
  thread from running a step ahead of the runner.  The JAX one builds its step
  once per process (``optax.inject_hyperparams``: the lr rides in the
  optimizer's state, set from the trial's config), so every trial and
  every PBT rebuild runs one compiled step.
"""

import copy
import functools
import os
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu import tune
from ray_tpu.models import gpt as jgpt
from ray_tpu.train.step import TrainState as JaxTrainState
from ray_tpu.train.step import make_train_step as jax_make_train_step
from ray_tpu.tune.schedulers import PopulationBasedTraining
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import gpt as tgpt
from ray_tpu_torch.train import (adamw, load_state, make_train_step,
                                 state_to_host)

# results that are wall-clock rates, never compared across packages
WALL_CLOCK = ("env_steps_per_sec",)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op torch thread while a module runs (a test module turns
    this on by importing it): the trials' eager ops are tiny, and eight
    threads on a loaded 8-core box took up to ~100x longer an op."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def assert_no_tensor(tree, where: str) -> None:
    """No ``torch.Tensor`` anywhere in ``tree`` (dicts, lists, tuples)."""
    if isinstance(tree, torch.Tensor):
        raise AssertionError(f"a torch.Tensor in {where}")
    if isinstance(tree, dict):
        for k, v in tree.items():
            assert_no_tensor(v, f"{where}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            assert_no_tensor(v, f"{where}[{i}]")


def port_trainable(algo_cls, on_restore=None) -> type:
    """A Trainable class over ``algo_cls`` built with ``device="cpu"``;
    ``on_restore(algo, saved, config)`` runs after every restore."""

    class PortTrainable(tune.Trainable):
        # (id of the trainable, config, the save, a deep copy of it)
        saves: list = []
        restores: list = []     # (id of the trainable, config, the save)

        def setup(self, config):
            self.algo = algo_cls({**config, "device": "cpu"})

        def train(self):
            result = self.algo.train()
            assert_no_tensor(result, "a result")
            return result

        def save(self):
            saved = self.algo.save()
            assert_no_tensor(saved, "a save")
            type(self).saves.append((id(self), dict(self.config), saved,
                                     copy.deepcopy(saved)))
            return saved

        def restore(self, saved):
            self.algo.restore(saved)
            type(self).restores.append((id(self), dict(self.config), saved))
            if on_restore is not None:
                on_restore(self.algo, saved, self.config)

        def cleanup(self):
            self.algo.cleanup()

        def reset_config(self, new_config):
            return self.algo.reset_config(new_config)

        @property
        def iteration(self):
            return self.algo.iteration

    PortTrainable.__name__ = f"Port{algo_cls.__name__}"
    return PortTrainable


def claim(path: str) -> bool:
    """True for the first caller that creates ``path``."""
    try:
        os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
        return True
    except FileExistsError:
        return False


def fail_once(cls) -> type:
    """``cls`` whose ``train`` raises once: at iteration
    ``config["fail_at"]`` of the first trial to claim
    ``config["fail_marker"]``."""

    class FailOnce(cls):
        def __init__(self, config=None):
            config = config or {}
            self._fail_at = config.get("fail_at")
            self._fail_marker = config.get("fail_marker")
            super().__init__(config)

        def train(self):
            if (self._fail_at is not None
                    and self.iteration + 1 == self._fail_at
                    and claim(self._fail_marker)):
                raise RuntimeError(f"injected failure at iteration "
                                   f"{self._fail_at}")
            return super().train()

    FailOnce.__name__ = f"FailOnce{cls.__name__}"
    return FailOnce


class RecordingPBT(PopulationBasedTraining):
    """PBT that records, in the order it sees them, every (trial id,
    result), the scores at every perturbation point (``decisions``) and
    every exploit as ``(iteration, source id, target id, new config,
    index of the deciding result, the source's config)``."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen: list = []
        self.exploits: list = []
        self.decisions: list = []
        self._configs: dict = {}

    def on_result(self, trial, result):
        self._configs[trial.trial_id] = dict(trial.config)
        self.seen.append((trial.trial_id, dict(result)))
        had = set(self.pending_exploits)
        before = self._last_perturb.get(trial.trial_id)
        decision = super().on_result(trial, result)
        if self._last_perturb.get(trial.trial_id) != before:
            # a perturbation point: the scores the quantiles were cut from
            self.decisions.append(dict(self._scores))
        if trial.trial_id in self.pending_exploits and \
                trial.trial_id not in had:
            src, new_cfg = self.pending_exploits[trial.trial_id]
            self.exploits.append((result["training_iteration"], src,
                                  trial.trial_id, dict(new_cfg),
                                  len(self.seen) - 1,
                                  dict(self._configs[src])))
        return decision

    def next_result(self, trial_id: str, after: int) -> dict:
        """The first result of ``trial_id`` seen after index ``after``."""
        return next(r for tid, r in self.seen[after + 1:]
                    if tid == trial_id)

    def last_result(self, trial_id: str, upto: int) -> dict:
        """The last result of ``trial_id`` seen at or before ``upto``."""
        return [r for tid, r in self.seen[:upto + 1] if tid == trial_id][-1]


def trial_summary(grid) -> list:
    """(trial id, config, status, iterations) of every trial of a
    ``ResultGrid``, in order."""
    return [(t.trial_id, t.config, t.status, t.iterations)
            for t in grid.trials]


def assert_results_close(got: list, want: list, *, atol=0.0, rtol=0.0,
                         skip=WALL_CLOCK) -> float:
    """Two histories of results: the same keys in each, every number
    within ``atol + rtol * |want|`` (wall-clock rates skipped), other
    values equal.  Returns the largest difference."""
    assert len(got) == len(want), (len(got), len(want))
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, set(g) ^ set(w))
        for k, v in w.items():
            if k in skip:
                continue
            if isinstance(v, (int, float, np.number)) and not isinstance(
                    v, bool):
                d = abs(float(g[k]) - float(v))
                assert d <= atol + rtol * abs(float(v)), (i, k, g[k], v)
                worst = max(worst, d)
            else:
                assert g[k] == v, (i, k, g[k], v)
    return worst


def trees_equal(got, want) -> bool:
    """Every leaf of two nested dicts/lists/tuples of numpy (or scalars)
    equal, bit for bit, with the same structure."""
    g, gs = jax.tree_util.tree_flatten(got)
    w, ws = jax.tree_util.tree_flatten(want)
    return gs == ws and all(np.array_equal(np.asarray(a), np.asarray(b))
                            for a, b in zip(g, w))


# ------------------------------------------------------------- GPT trials

GPT_STEPS = 5
GPT_BATCHES = 3      # step i trains on batch i % GPT_BATCHES
WEIGHT_DECAY = 0.1


@functools.lru_cache(maxsize=None)
def gpt_setup():
    """Both packages' tiny f32 configs, numpy weights (N(0, 0.02), norm
    scales 1) in the shared stacked layout, and the fixed b2 s32 token
    batches."""
    jcfg = jgpt.GPTConfig.tiny(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.tiny(dtype=torch.float32)
    rng = np.random.default_rng(0)

    def draw(name, t):
        if "scale" in name:
            return np.ones(t.shape, np.float32)
        return (rng.standard_normal(t.shape) * 0.02).astype(np.float32)

    shapes = tgpt.init_params(tcfg, 0, device="cpu")
    tree = {k: ({n: draw(n, t) for n, t in v.items()}
                if isinstance(v, dict) else draw(k, v))
            for k, v in shapes.items()}
    batches = [rng.integers(0, jcfg.vocab_size, (2, 33)).astype(np.int32)
               for _ in range(GPT_BATCHES)]
    return jcfg, tcfg, tree, batches


GATE = "_lockstep"


def lockstep(fn) -> type:
    """``tune.wrap_function(fn)`` whose function takes each step only when
    the runner asks for its result: ``fn`` waits on ``config[GATE]``, a
    semaphore the runner's ``step`` releases.  Without it the function's
    thread runs a step ahead: ``tune.report`` stores the next step's
    checkpoint before the runner takes that step's result, so a save made
    meanwhile (PBT cloning a source, a periodic checkpoint) holds a state
    one step past the save's iteration (ROADMAP Queue C, R2)."""

    class Lockstep(tune.wrap_function(fn)):
        def setup(self, config):
            super().setup(config)
            self._gate = threading.Semaphore(0)
            self.config = {**config, GATE: self._gate}

        def step(self):
            if not self._done:
                self._gate.release()
            return super().step()

        def cleanup(self):
            super().cleanup()
            # a function waiting at its gate goes on to its next report,
            # which raises StopTrial
            self._gate.release()

    Lockstep.__name__ = f"lockstep_{fn.__name__}"
    return Lockstep


def _take_turn(config) -> None:
    gate = config.get(GATE)
    if gate is not None:
        gate.acquire()


# weak references to the port states of the GPT trials (a trial's state
# must die with its function's thread) and those threads
PORT_STATES: list = []
PORT_THREADS: list = []


def port_gpt_train_fn(config):
    """The port's step on the CPU: ``make_train_step`` with
    ``adamw(config["lr"])``; the state from the numpy weights, or from
    ``tune.get_checkpoint()`` through ``load_state``."""
    _, tcfg, tree, batches = gpt_setup()
    PORT_THREADS.append(threading.current_thread())
    init_fn, step_fn = make_train_step(
        lambda p, b: tgpt.loss_fn(p, b, tcfg),
        adamw(config["lr"], weight_decay=WEIGHT_DECAY))
    state = init_fn(convert.params_from_numpy(tree, device="cpu"))
    ck = tune.get_checkpoint()
    if ck:
        load_state(state, ck)
    PORT_STATES.append(weakref.ref(state))
    while int(state.step) < GPT_STEPS:
        _take_turn(config)
        toks = batches[int(state.step) % GPT_BATCHES]
        state, m = step_fn(state, {"tokens": torch.from_numpy(toks).long()})
        payload = state_to_host(state)
        assert_no_tensor(payload, "the GPT checkpoint")
        tune.report({"loss": m["loss"].item(),
                     "grad_norm": m["grad_norm"].item(),
                     "step": int(state.step),
                     "lr": state.opt_state.param_groups[0]["lr"]},
                    checkpoint=payload)


@functools.lru_cache(maxsize=None)
def _jax_gpt_step():
    """JAX's (init_fn, step_fn), built once: the lr is a hyperparameter
    in the optimizer's state, so every trial runs one compiled step."""
    jcfg = gpt_setup()[0]
    tx = optax.inject_hyperparams(optax.adamw)(
        learning_rate=0.0, weight_decay=WEIGHT_DECAY)
    return jax_make_train_step(lambda p, b: jgpt.loss_fn(p, b, jcfg), tx)


def _with_lr(opt_state, lr: float):
    hp = dict(opt_state.hyperparams)
    hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
    return opt_state._replace(hyperparams=hp)


def jax_gpt_train_fn(config):
    """The JAX package's ``make_train_step`` with optax's AdamW at
    ``config["lr"]``, restored from ``tune.get_checkpoint()`` the same
    way (the lr is the trial's, not the source's)."""
    _, _, tree, batches = gpt_setup()
    init_fn, step_fn = _jax_gpt_step()
    state = init_fn(jax.tree_util.tree_map(jnp.asarray, tree))
    ck = tune.get_checkpoint()
    if ck:
        state = JaxTrainState(
            step=jnp.asarray(ck["step"], jnp.int32),
            params=jax.tree_util.tree_map(jnp.asarray, ck["params"]),
            opt_state=jax.tree_util.tree_map(jnp.asarray, ck["opt_state"]))
    state.opt_state = _with_lr(state.opt_state, config["lr"])
    while int(state.step) < GPT_STEPS:
        _take_turn(config)
        toks = batches[int(state.step) % GPT_BATCHES]
        state, m = step_fn(state, {"tokens": jnp.asarray(toks)})
        tune.report({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "step": int(state.step),
                     "lr": float(state.opt_state.hyperparams[
                         "learning_rate"])},
                    checkpoint={"step": int(state.step),
                                "params": jax.tree_util.tree_map(
                                    np.asarray, state.params),
                                "opt_state": jax.tree_util.tree_map(
                                    np.asarray, state.opt_state)})
