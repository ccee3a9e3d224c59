"""Connectors: composable observation/action transform pipelines, the
port of ``ray_tpu/rllib/connectors.py`` (a numpy copy).

Connectors are small stateful objects with ``__call__(data) -> data``
plus ``state()``/``set_state()``; pipelines are ordered lists that
serialise to and from plain dicts, so a pipeline saved by either package
loads in the other.  They run on the host, once per env step.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np

_REGISTRY: Dict[str, type] = {}


def register_connector(cls):
    """Class decorator: make a connector creatable by name."""
    _REGISTRY[cls.__name__] = cls
    return cls


class Connector:
    """Base transform. Subclasses override __call__ and optionally
    state()/set_state() for learned statistics."""

    def __call__(self, x):
        raise NotImplementedError

    def reset(self) -> None:
        """Called at episode boundaries (frame stacks etc.)."""

    def state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        pass

    def to_config(self) -> dict:
        return {"type": type(self).__name__, "kwargs": self._kwargs(),
                "state": self.state()}

    def _kwargs(self) -> dict:
        return {}

    @staticmethod
    def from_config(cfg: dict) -> "Connector":
        cls = _REGISTRY[cfg["type"]]
        c = cls(**cfg.get("kwargs", {}))
        c.set_state(cfg.get("state", {}))
        return c


@register_connector
class FlattenObs(Connector):
    """Flatten any obs to 1-D float32 (reference:
    ObsPreprocessorConnector with flatten preprocessor)."""

    def __call__(self, obs):
        return np.asarray(obs, np.float32).reshape(-1)


@register_connector
class MeanStdFilter(Connector):
    """Running mean/std observation normalization (reference:
    MeanStdFilterConnector / utils/filter.py MeanStdFilter).
    Welford online update; statistics ride checkpoints."""

    def __init__(self, clip: float = 10.0):
        self.clip = clip
        self._n = 0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def _kwargs(self):
        return {"clip": self.clip}

    def __call__(self, obs):
        x = np.asarray(obs, np.float64).reshape(-1)
        if self._mean is None:
            self._mean = np.zeros_like(x)
            self._m2 = np.zeros_like(x)
        self._n += 1
        delta = x - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (x - self._mean)
        std = np.sqrt(self._m2 / max(1, self._n - 1)) + 1e-8
        out = (x - self._mean) / std
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def state(self):
        if self._mean is None:
            return {}
        return {"n": self._n, "mean": self._mean.tolist(),
                "m2": self._m2.tolist()}

    def set_state(self, state):
        if state:
            self._n = state["n"]
            self._mean = np.asarray(state["mean"])
            self._m2 = np.asarray(state["m2"])


@register_connector
class FrameStack(Connector):
    """Stack the last k observations along a new leading axis
    (reference: FrameStackingConnector)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: collections.deque = collections.deque(maxlen=k)

    def _kwargs(self):
        return {"k": self.k}

    def reset(self):
        self._frames.clear()

    def __call__(self, obs):
        x = np.asarray(obs, np.float32)
        while len(self._frames) < self.k - 1:
            self._frames.append(np.zeros_like(x))
        self._frames.append(x)
        return np.stack(self._frames)


@register_connector
class ClipReward(Connector):
    """Clip (or sign) rewards (reference: ClipRewardConnector)."""

    def __init__(self, limit: float = 1.0, sign: bool = False):
        self.limit, self.sign = limit, sign

    def _kwargs(self):
        return {"limit": self.limit, "sign": self.sign}

    def __call__(self, rew):
        if self.sign:
            return float(np.sign(rew))
        return float(np.clip(rew, -self.limit, self.limit))


@register_connector
class ClipActions(Connector):
    """Clip continuous actions into [low, high] (reference:
    ClipActionsConnector)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def _kwargs(self):
        return {"low": self.low.tolist(), "high": self.high.tolist()}

    def __call__(self, action):
        return np.clip(np.asarray(action, np.float32), self.low, self.high)


@register_connector
class UnsquashActions(Connector):
    """Map tanh-squashed [-1, 1] model outputs to [low, high]
    (reference: NormalizeActionsConnector inverse)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def _kwargs(self):
        return {"low": self.low.tolist(), "high": self.high.tolist()}

    def __call__(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        return self.low + (a + 1.0) * 0.5 * (self.high - self.low)


class ConnectorPipeline:
    """Ordered connector chain (reference: agent_pipeline.py /
    action_pipeline.py)."""

    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def append(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.append(c)
        return self

    def prepend(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.insert(0, c)
        return self

    def remove(self, name: str) -> None:
        self.connectors = [c for c in self.connectors
                           if type(c).__name__ != name]

    def reset(self) -> None:
        for c in self.connectors:
            c.reset()

    def to_config(self) -> list:
        return [c.to_config() for c in self.connectors]

    @staticmethod
    def from_config(cfgs: list) -> "ConnectorPipeline":
        return ConnectorPipeline(
            [Connector.from_config(c) for c in cfgs])
