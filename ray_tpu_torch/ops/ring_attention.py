"""Ring attention: exact attention over a sequence-sharded axis, the port
of ``ray_tpu/ops/ring_attention.py``.

Each ``sp`` shard holds a contiguous sequence block of q/k/v; the kv
blocks rotate around the ring (``collectives.permute``) while every
shard folds the incoming block into an online-softmax accumulator.  After
``axis_size`` steps each query has attended to the whole sequence.  Plain
torch math in f32, as in the JAX package (which has no Pallas kernel
here); the gradient is autograd's through the same steps, each hand-off
handing its cotangent back the other way round the ring.

Run it on local shards, inside ``shard_call``/``shard_fn`` with the
sequence dim split over ``axis_name``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.parallel.collectives import (_axis_size, axis_index,
                                                permute, ring_perm)

# a finite mask value, as in the JAX package: a block with every key
# masked gives exp(NEG_INF - NEG_INF) = 1, never exp(-inf - -inf) = NaN,
# and its weights vanish once a visible block raises the row's max
NEG_INF = -1e30


def ring_attention(q, k, v, axis_name: str, *, causal: bool = True,
                   scale: Optional[float] = None, mesh=None):
    """Exact attention, q/k/v = local shards [b, h, s_local, d].

    Global sequence order = shard order along ``axis_name`` (shard i holds
    positions [i*s_local, (i+1)*s_local))."""
    s = (q.shape[-1] ** -0.5) if scale is None else scale
    axis_size = _axis_size(axis_name, mesh)
    my_idx = axis_index(axis_name, mesh=mesh)
    b, h, sl, d = q.shape
    dev = q.device
    qf = q.float()
    q_pos = my_idx * sl + torch.arange(sl, device=dev)
    perm = ring_perm(axis_size)

    acc = torch.zeros((b, h, sl, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sl, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sl, 1), dtype=torch.float32, device=dev)
    k_cur, v_cur = k, v
    for i in range(axis_size):
        # after i forward rotations we hold the kv of shard (my_idx - i)
        src = (my_idx - i) % axis_size
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float()) * s
        if causal:
            k_pos = src * sl + torch.arange(sl, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
        m_next = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(logits - m_next)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         v_cur.float())
        m = m_next
        if i + 1 < axis_size:        # the last block needs no hand-off
            k_cur = permute(k_cur, axis_name, perm, mesh=mesh)
            v_cur = permute(v_cur, axis_name, perm, mesh=mesh)
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).to(q.dtype)
