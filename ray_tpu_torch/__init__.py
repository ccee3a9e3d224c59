"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute path.

The package mirrors ``ray_tpu``'s layout (``core/``, ``ops/``,
``models/``, ``inference/``, ``serve/``, ``train/``, ``data/``,
``rllib/``, ``parallel/``) and imports torch and numpy,
never jax and never ``ray_tpu``.  Entry points take ``device=None``,
which means the CUDA card; with no card that raises.  The CPU runs only when a caller
passes ``device="cpu"``, as the tests do.  Every kernel is hand-written
for Hopper (``ops/csrc/``) and built from source at first use.
"""

from ray_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
