"""Attention ops: dispatch, the plain reference, and the Hopper flash
kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``) with their plain
versions, and ring attention over a sequence-parallel mesh axis."""

from ray_tpu_torch.ops.attention import (attention, mha_reference,
                                         paged_attention)
from ray_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_backward_reference,
    flash_attention_reference, flash_attention_with_lse)
from ray_tpu_torch.ops.ring_attention import ring_attention

__all__ = ["attention", "mha_reference", "paged_attention",
           "flash_attention", "flash_attention_backward_reference",
           "flash_attention_reference", "flash_attention_with_lse",
           "ring_attention"]
