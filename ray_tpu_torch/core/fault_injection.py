"""The fault plane's gate: the armed plan the inference engine's chaos
hooks consult.

The port's own copy of the gate in ``ray_tpu/core/fault_injection.py``
(``_active``, ``active``, ``install``, ``uninstall``, ``injected``).  A
plan is any object with ``on_infer(point, ctx)``; the engine calls it at
its choke points:

  * ``infer_admit``       -- a request was granted a row and blocks at a
    prefill boundary (ctx: ``engine``, ``req``, ``need``, ``hit_tokens``);
  * ``infer_block_alloc`` -- decode-time block growth (ctx: ``engine``,
    ``row``);
  * ``infer_speculate``   -- a speculative pass is about to verify its
    drafts (ctx: ``engine``, ``rows``, ``drafted``).  The plan may set
    ``ctx["reject_all"] = True`` to force every draft to be rejected.

A plan that raises injects a failure at that point, and the engine takes
its recovery path.  The JAX package's ``FaultPlan`` has ``on_infer``, so
a host that imports both packages may install one here.  Plans are
installed in process only: there is no environment autoinstall.

With no plan installed each hook costs one global load
(``_active is None``).
"""

from __future__ import annotations

from typing import Any, Optional

# The armed plan.  Hooks read this module attribute directly, so the
# disabled path costs one global load.
_active: Optional[Any] = None


def active() -> Optional[Any]:
    return _active


def install(plan: Any) -> Any:
    global _active
    _active = plan
    return plan


def uninstall() -> None:
    global _active
    _active = None


class injected:
    """``with fault_injection.injected(plan): ...`` -- scoped install."""

    def __init__(self, plan: Any):
        self.plan = plan

    def __enter__(self) -> Any:
        return install(self.plan)

    def __exit__(self, *exc) -> bool:
        uninstall()
        return False
