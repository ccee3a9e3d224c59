"""The port's AlphaStar league against the JAX package's on the CPU, in
f32:

- the two ``League`` tests of ``tests/test_rllib_distributed_tail.py``
  (PFSP weights hard opponents up; a snapshot freezes a copy and inherits
  its parent's payoffs) on the port's ``League``, its PFSP weights within
  rel 1e-6 of JAX's;
- that file's 100-iteration run (seed 0, snapshots every 5, entropy
  0.05, league lr 0.3) on both packages: the same league keys and player
  ids, every metric within 1e-5 and every player's logits within atol
  1e-5 at every iteration (both start from the same numpy draws); the
  JAX test's bars met (league exploitability below 0.25, the main
  exploiter's edge below 0.25, more than 10 players);
- a checkpoint made by either package loads in the other.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib import alpha_star as ja
from ray_tpu_torch.rllib import alpha_star as ta

RUN = dict(seed=0, snapshot_every=5, entropy_coeff=0.05, league_lr=0.3)
ITERS = 100


def _warm(jalgo):
    """Compile JAX's two jitted functions for every opponent-stack size
    the run meets, on a thread pool (each new size compiles anew; XLA
    compiles without the GIL)."""
    snaps = ITERS // RUN["snapshot_every"]
    sizes = sorted({k for s in range(snaps + 1)
                    for k in (4 + 3 * s, 2 + s, 1 + 3 * s)})

    def warm(k):
        lg, opp = jnp.zeros(3, jnp.float32), jnp.zeros((k, 3), jnp.float32)
        jalgo._pg_update(lg, opp, jnp.full(k, 1.0 / k, jnp.float32))
        jax.vmap(jalgo._expected_payoff, in_axes=(None, 0))(lg, opp)
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(warm, sizes))


@pytest.fixture(scope="module")
def runs():
    """Both packages' 100 iterations -> (JAX algo, port algo, the worst
    metric and logits differences over the run, the last results)."""
    jalgo = ja.AlphaStarConfig(**RUN).build()
    port = ta.AlphaStarConfig(**RUN, device="cpu").build()
    _warm(jalgo)
    worst_metric = worst_logits = 0.0
    for it in range(ITERS):
        jr, tr = jalgo.train(), port.train()
        assert set(jr) == set(tr), it
        assert list(port.league.players) == list(jalgo.league.players)
        for k, v in jr.items():
            if k not in ("env_steps_per_sec", "training_iteration"):
                worst_metric = max(worst_metric, abs(float(tr[k]) - v))
        worst_logits = max(worst_logits, max(
            float(np.abs(port.league.players[p].logits - q.logits).max())
            for p, q in jalgo.league.players.items()))
    return jalgo, port, worst_metric, worst_logits, jr, tr


def _leagues():
    return ja.League(), ta.League()


def test_pfsp_prioritizes_hard_opponents_as_jax():
    leagues = _leagues()
    for lg, mod in zip(leagues, (ja, ta)):
        for pid in ("main", "easy", "hard"):
            lg.add(mod.Player(pid, "main", np.zeros(3, np.float32),
                              frozen=(pid != "main")))
        for _ in range(20):
            lg.record("main", "easy", 1.0)
            lg.record("main", "hard", -1.0)
    jw, tw = (lg.pfsp_weights("main", ["easy", "hard"]) for lg in leagues)
    w = dict(zip(["easy", "hard"], tw))
    assert w["hard"] > 2 * w["easy"]
    np.testing.assert_allclose(tw, jw, rtol=1e-6)
    assert leagues[1].frozen_ids() == leagues[0].frozen_ids() == [
        "easy", "hard"]


def test_snapshot_freezes_and_inherits_payoffs_as_jax():
    leagues = _leagues()
    for lg, mod in zip(leagues, (ja, ta)):
        lg.add(mod.Player("main", "main", np.array([1., 0., 0.],
                                                   np.float32)))
        lg.add(mod.Player("x", "league_exploiter", np.zeros(3, np.float32)))
        lg.record("main", "x", 0.5)
    sids = [lg.snapshot("main") for lg in leagues]
    assert sids[0] == sids[1] == "main:snap0"
    lg = leagues[1]
    snap = lg.players[sids[1]]
    assert snap.frozen and snap.parent == "main"
    assert lg.payoff[(sids[1], "x")] == lg.payoff[("main", "x")]
    assert lg.payoff == leagues[0].payoff
    lg.players["main"].logits[0] = -9.0       # the snapshot is a copy
    assert snap.logits[0] == 1.0
    assert ta.rps_payoff(5).tolist() == ja.rps_payoff(5).tolist()


def test_hundred_iterations_match_jax(runs):
    jalgo, port, worst_metric, worst_logits, jr, tr = runs
    assert worst_metric <= 1e-5, worst_metric
    assert worst_logits <= 1e-5, worst_logits
    assert port.league.payoff.keys() == jalgo.league.payoff.keys()
    for p, q in jalgo.league.players.items():
        t = port.league.players[p]
        assert (t.kind, t.frozen, t.parent) == (q.kind, q.frozen, q.parent)
    assert tr["league_size"] == jr["league_size"]


def test_the_jax_tests_bars_are_met(runs):
    *_, jr, tr = runs
    for r in (jr, tr):
        assert r["league_exploitability"] < 0.25, r
        assert abs(r.get("mexp0_vs_main", 1.0)) < 0.25, r
        assert r["league_size"] > 10


def test_checkpoints_load_across_packages(runs):
    jalgo, port = runs[:2]
    into_port = ta.AlphaStarConfig(seed=9, device="cpu").build()
    into_port.load_checkpoint(jalgo.save_checkpoint())
    into_jax = ja.AlphaStarConfig(seed=9).build()
    into_jax.load_checkpoint(port.save_checkpoint())
    for got, want in ((into_port, jalgo), (into_jax, port)):
        assert set(got.league.players) == set(want.league.players)
        assert got.league.payoff == want.league.payoff
        assert got._iter == want._iter == ITERS
        for pid, p in want.league.players.items():
            assert np.array_equal(got.league.players[pid].logits, p.logits)
    # the restored port league trains on as the JAX one does
    r = into_port.train()
    assert r["league_size"] == len(into_port.league.players)


def test_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.AlphaStarConfig().build()
