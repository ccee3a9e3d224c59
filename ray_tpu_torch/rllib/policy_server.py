"""External-env serving, the port of ``ray_tpu/rllib/policy_server.py``
(a stdlib copy): ``PolicyServerInput``, a ThreadingHTTPServer speaking
JSON that serves a policy's actions and gathers finished episodes into
the port's ``SampleBatch``es for a training loop to drain with
``next_batch()``, and ``PolicyClient``, the external application's side
(start_episode / get_action / log_returns / end_episode).  The wire
format is the JAX package's, so either package's client talks to the
other's server.
"""

from __future__ import annotations

import json
import threading
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib import sample_batch as SB
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class _Episode:
    def __init__(self, training: bool):
        self.training = training
        self.obs: List = []
        self.actions: List = []
        self.rewards: List = []
        self.total = 0.0


class PolicyServerInput:
    """Serve get_action over HTTP and collect training episodes
    (reference: policy_server_input.py:61 PolicyServerInput)."""

    def __init__(self, policy_fn: Callable[[np.ndarray], int],
                 host: str = "127.0.0.1", port: int = 0):
        self._policy_fn = policy_fn
        self._episodes: Dict[str, _Episode] = {}
        self._complete: List[SampleBatch] = []
        self._returns: List[float] = []
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                try:
                    out = outer._handle(self.path, req)
                    body = json.dumps(out).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001 - wire back to client
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = f"http://{host}:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- request dispatch --------------------------------------------------
    def _handle(self, path: str, req: dict) -> dict:
        with self._lock:
            if path == "/start_episode":
                eid = req.get("episode_id") or uuid.uuid4().hex[:12]
                self._episodes[eid] = _Episode(
                    training=bool(req.get("training_enabled", True)))
                return {"episode_id": eid}
            ep = self._episodes.get(req.get("episode_id", ""))
            if ep is None:
                raise ValueError("unknown episode_id")
            if path == "/get_action":
                obs = np.asarray(req["observation"], np.float32)
                action = self._policy_fn(obs)
                ep.obs.append(obs)
                ep.actions.append(action)
                return {"action": np.asarray(action).tolist()}
            if path == "/log_returns":
                rew = float(req["reward"])
                # reward for the most recent action
                ep.rewards.append(rew)
                ep.total += rew
                return {}
            if path == "/end_episode":
                eid = req["episode_id"]
                self._finish(eid, req.get("observation"))
                return {}
            raise ValueError(f"unknown endpoint {path}")

    def _finish(self, eid: str, last_obs) -> None:
        ep = self._episodes.pop(eid)
        self._returns.append(ep.total)
        if not ep.training or not ep.actions:
            return
        T = len(ep.actions)
        rewards = ep.rewards + [0.0] * (T - len(ep.rewards))
        dones = np.zeros(T, np.float32)
        dones[-1] = 1.0
        self._complete.append(SampleBatch({
            SB.OBS: np.stack(ep.obs),
            SB.ACTIONS: np.asarray(ep.actions),
            SB.REWARDS: np.asarray(rewards[:T], np.float32),
            SB.DONES: dones}))

    # -- training-side surface --------------------------------------------
    def next_batch(self, min_steps: int = 1,
                   timeout: Optional[float] = None) -> Optional[SampleBatch]:
        """Drain completed episodes totalling >= min_steps (None if none
        arrive before timeout; timeout=None polls once)."""
        import time
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._lock:
                have = sum(b.count for b in self._complete)
                if have >= min_steps:
                    out, self._complete = self._complete, []
                    return SampleBatch.concat_samples(out)
            if deadline is None or time.time() > deadline:
                return None
            time.sleep(0.01)

    def episode_returns(self) -> List[float]:
        with self._lock:
            out, self._returns = self._returns, []
            return out

    def set_policy_fn(self, policy_fn) -> None:
        with self._lock:
            self._policy_fn = policy_fn

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class PolicyClient:
    """External application's HTTP client (reference:
    policy_client.py:40 PolicyClient)."""

    def __init__(self, address: str, timeout: float = 30.0):
        self.address = address.rstrip("/")
        self.timeout = timeout

    def _post(self, path: str, payload: dict) -> dict:
        req = urllib.request.Request(
            self.address + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise RuntimeError(out["error"])
        return out

    def start_episode(self, episode_id: Optional[str] = None,
                      training_enabled: bool = True) -> str:
        return self._post("/start_episode",
                          {"episode_id": episode_id,
                           "training_enabled": training_enabled}
                          )["episode_id"]

    def get_action(self, episode_id: str, observation) -> np.ndarray:
        out = self._post("/get_action", {
            "episode_id": episode_id,
            "observation": np.asarray(observation).tolist()})
        return np.asarray(out["action"])

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._post("/log_returns",
                   {"episode_id": episode_id, "reward": float(reward)})

    def end_episode(self, episode_id: str, observation=None) -> None:
        self._post("/end_episode", {
            "episode_id": episode_id,
            "observation": (np.asarray(observation).tolist()
                            if observation is not None else None)})
