"""Attention ops: dispatch, the plain reference, and the Hopper flash
kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) with their plain
versions."""

from ray_tpu_torch.ops.attention import (attention, mha_reference,
                                         paged_attention)
from ray_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward_reference,
    flash_attention_reference, flash_attention_with_lse)

__all__ = ["attention", "mha_reference", "paged_attention",
           "flash_attention", "flash_attention_backward_reference",
           "flash_attention_reference", "flash_attention_with_lse"]
