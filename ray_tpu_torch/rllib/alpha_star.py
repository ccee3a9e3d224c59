"""AlphaStar-style league training, the port of
``ray_tpu/rllib/alpha_star.py``: ``rps_payoff``, ``Player``, ``League``,
``AlphaStarConfig`` and ``AlphaStar``.

A league of three learner roles (the main agent, main exploiters,
league exploiters) and frozen snapshots, an EMA payoff table over every
pair of players and prioritized fictitious self-play (PFSP) weighting
hard opponents (Vinyals et al. 2019).  Players are logits over the
actions of a symmetric zero-sum matrix game.  The league's bookkeeping
is numpy, as in the JAX package; each learner's entropy-anchored mirror
ascent step and the expected payoffs against its whole opponent stack
(one batched product) run as torch on the algorithm's device.  The
initial logits are the JAX package's numpy draws
(``np.random.RandomState(seed)``), so both packages start equal and
checkpoints load across them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig


def rps_payoff(n_actions: int = 3) -> np.ndarray:
    """Generalized rock-paper-scissors: A[i, j] = payoff of i vs j."""
    A = np.zeros((n_actions, n_actions), np.float32)
    for i in range(n_actions):
        A[i, (i + 1) % n_actions] = -1.0
        A[(i + 1) % n_actions, i] = 1.0
    return A


@dataclass
class Player:
    pid: str
    kind: str               # main | main_exploiter | league_exploiter
    logits: np.ndarray
    frozen: bool = False
    parent: Optional[str] = None


class League:
    """The payoff table (an EMA of each pair's result) and PFSP
    matchmaking."""

    def __init__(self):
        self.players: dict[str, Player] = {}
        # payoff[(a, b)] ~ E[result of a vs b]
        self.payoff: dict[tuple[str, str], float] = {}

    def add(self, p: Player) -> None:
        self.players[p.pid] = p

    def record(self, a: str, b: str, result: float,
               ema: float = 0.2) -> None:
        cur = self.payoff.get((a, b), 0.0)
        self.payoff[(a, b)] = (1 - ema) * cur + ema * result
        self.payoff[(b, a)] = -self.payoff[(a, b)]

    def win_prob(self, a: str, b: str) -> float:
        # the payoff in [-1, 1] squashed to a pseudo win rate
        return 0.5 * (self.payoff.get((a, b), 0.0) + 1.0) * 0.5 + 0.25

    def pfsp_weights(self, learner: str, opponents: list[str],
                     mode: str = "squared") -> np.ndarray:
        """Weights hard opponents up: f(p) = (1 - p)^2, floored at 1e-3,
        normalised."""
        ps = np.array([self.win_prob(learner, o) for o in opponents])
        w = (1.0 - ps) ** 2 if mode == "squared" else np.ones_like(ps)
        w = np.maximum(w, 1e-3)
        return w / w.sum()

    def frozen_ids(self) -> list[str]:
        return [p.pid for p in self.players.values() if p.frozen]

    def snapshot(self, pid: str) -> str:
        """Freeze a copy of ``pid``; it starts with its parent's payoffs."""
        src = self.players[pid]
        n = sum(1 for q in self.players.values() if q.parent == pid)
        snap_id = f"{pid}:snap{n}"
        self.add(Player(snap_id, src.kind, src.logits.copy(),
                        frozen=True, parent=pid))
        for (a, b), v in list(self.payoff.items()):
            if a == pid:
                self.payoff[(snap_id, b)] = v
                self.payoff[(b, snap_id)] = -v
        return snap_id


@dataclass
class AlphaStarConfig(AlgorithmConfig):
    n_actions: int = 3
    payoff_fn: Callable = rps_payoff
    num_main_exploiters: int = 1
    num_league_exploiters: int = 1
    matches_per_pair: int = 256
    snapshot_every: int = 10
    league_lr: float = 0.2
    entropy_coeff: float = 0.01

    def build(self, algo_cls=None) -> "AlphaStar":
        return AlphaStar({"_config": self})


class AlphaStar(Algorithm):
    _default_config = AlphaStarConfig

    def _build(self):
        cfg = self.config
        self.device = resolve_device(cfg.device)
        self.A = torch.as_tensor(cfg.payoff_fn(cfg.n_actions),
                                 dtype=torch.float32).to(self.device)
        self.league = League()
        rng = np.random.RandomState(cfg.seed)

        def fresh():
            return (rng.randn(cfg.n_actions) * 0.3).astype(np.float32)

        self.league.add(Player("main", "main", fresh()))
        for i in range(cfg.num_main_exploiters):
            self.league.add(Player(f"mexp{i}", "main_exploiter", fresh()))
        for i in range(cfg.num_league_exploiters):
            self.league.add(Player(f"lexp{i}", "league_exploiter",
                                   fresh()))
        # league history, so PFSP has opponents on iteration 0
        self.league.snapshot("main")
        self._iter = 0

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def _pg_update(self, lg, opp_lgs, opp_w):
        """Entropy-anchored mirror ascent on the PFSP-weighted expected
        payoff (magnetic mirror descent, Sokota et al. 2023): the logit
        decay is the entropy magnet."""
        mix = opp_w @ torch.softmax(opp_lgs, dim=-1)
        return ((1.0 - self.config.entropy_coeff) * lg
                + self.config.league_lr * (self.A @ mix))

    def _opponents_for(self, p: Player) -> list[str]:
        """The main agent plays the whole league (itself, the frozen
        players, the other learners); a main exploiter the main agent and
        its snapshots; a league exploiter the frozen league."""
        frozen = self.league.frozen_ids()
        if p.kind == "main":
            return ["main"] + frozen + [
                q.pid for q in self.league.players.values()
                if q.kind != "main" and not q.frozen]
        if p.kind == "main_exploiter":
            return ["main"] + [f for f in frozen if f.startswith("main:")]
        return frozen or ["main"]

    @torch.no_grad()
    def training_step(self) -> dict:
        cfg = self.config
        self._iter += 1
        learners = [p for p in self.league.players.values() if not p.frozen]
        metrics: dict = {}
        for p in learners:
            opps = self._opponents_for(p)
            w = self.league.pfsp_weights(p.pid, opps)
            opp_lgs = self._on_device(
                np.stack([self.league.players[o].logits for o in opps]))
            lg = self._pg_update(self._on_device(p.logits), opp_lgs,
                                 self._on_device(w))
            p.logits = lg.cpu().numpy()
            # the exact expected payoff against every opponent at once
            # stands in for match outcomes (the EMA bookkeeping is kept)
            results = ((torch.softmax(lg, dim=-1) @ self.A)
                       @ torch.softmax(opp_lgs, dim=-1).T).cpu().numpy()
            for o, res in zip(opps, results):
                self.league.record(p.pid, o, float(res))
        if self._iter % cfg.snapshot_every == 0:
            for p in learners:
                self.league.snapshot(p.pid)

        # exploitability of the latest main agent (gradient play cycles on
        # zero-sum games) and of the main agent's league mixture (its
        # snapshots and itself, the fictitious-play average)
        main = self.league.players["main"]
        pm = torch.softmax(self._on_device(main.logits), dim=-1)
        metrics["main_exploitability"] = float((self.A @ pm).max())
        mix = [torch.softmax(self._on_device(q.logits), dim=-1).cpu().numpy()
               for q in self.league.players.values()
               if q.pid == "main" or (q.parent == "main" and q.frozen)]
        pmix = self._on_device(np.mean(mix, axis=0))
        metrics["league_exploitability"] = float((self.A @ pmix).max())
        metrics["league_size"] = len(self.league.players)
        for p in learners:
            if p.kind != "main":
                metrics[f"{p.pid}_vs_main"] = self.league.payoff.get(
                    (p.pid, "main"), 0.0)
        metrics["steps_this_iter"] = cfg.matches_per_pair
        self._timesteps += cfg.matches_per_pair
        return metrics

    def save_checkpoint(self) -> dict:
        return {"players": {pid: (p.kind, p.logits, p.frozen, p.parent)
                            for pid, p in self.league.players.items()},
                "payoff": dict(self.league.payoff),
                "iter": self._iter,
                "timesteps": self._timesteps}

    def load_checkpoint(self, ck):
        self.league.players = {
            pid: Player(pid, k, np.array(lg, np.float32), frozen=fr,
                        parent=par)
            for pid, (k, lg, fr, par) in ck["players"].items()}
        self.league.payoff = dict(ck["payoff"])
        self._iter = ck.get("iter", 0)
        self._timesteps = ck.get("timesteps", 0)
