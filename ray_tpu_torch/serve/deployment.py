"""Deployments: the servable unit a serve controller turns into replicas.

The port's own copy of ``ray_tpu/serve/deployment.py``'s
``AutoscalingConfig``, ``DeploymentOptions`` and ``Deployment``, so that
``build_gpt_deployment`` returns an object with the JAX package's fields
and ``build_replica()``.  The JAX package's ``bind``/``set_options`` and
function deployments have no caller in the port and are left out.  The
port has no controller of its own: a host builds replicas through
``build_replica()``, under ``serve.context.replica_context`` for a named
replica.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class AutoscalingConfig:
    """Scale to keep per-replica ongoing requests near the target."""
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0


@dataclass
class DeploymentOptions:
    name: str = ""
    num_replicas: int = 1
    max_concurrent_queries: int = 8
    autoscaling: Optional[AutoscalingConfig] = None
    ray_actor_options: dict = field(default_factory=dict)
    use_actors: Optional[bool] = None    # None = actors iff runtime up


class Deployment:
    """A configured (not yet running) deployment."""

    def __init__(self, cls: type, options: DeploymentOptions,
                 init_args: tuple = (), init_kwargs: Optional[dict] = None):
        self._target = cls
        self.options = options
        self.init_args = init_args
        self.init_kwargs = init_kwargs or {}

    @property
    def name(self) -> str:
        return self.options.name or getattr(
            self._target, "__name__", "deployment")

    def build_replica(self):
        """Instantiate the target class (one replica's worth)."""
        return self._target(*self.init_args, **self.init_kwargs)
