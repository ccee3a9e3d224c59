"""The port's serve layer: the replica's vocabulary and contract.

  * qos.py        -- request priorities and the typed replica errors
                     (draining, dead, the prefix plane's four).
  * multiplex.py  -- ModelMultiplexer: an LRU of model variants per
                     replica, and UnknownModelError.
  * deployment.py -- Deployment, DeploymentOptions, AutoscalingConfig.
  * context.py    -- the replica identity a host sets while it builds a
                     replica body.

The controller, router, fleet ingress and HTTP proxies are not ported:
a host that imports both packages runs the port's replicas under the
JAX package's ``ray_tpu.serve`` (README, "Hosting the port under
ray_tpu.serve").
"""
