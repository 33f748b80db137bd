"""Ring attention — sequence/context parallelism over mesh axis ``sp``.

The JAX package's ``parallel/ring.py`` on the port's single-controller
mesh. The sequence is split over the ``sp`` ranks; each holds its Q/K/V
shard, and the K/V blocks rotate one rank forward a step (rank ``i``
takes the block rank ``i - 1`` held: ``lax.ppermute`` with ``perm=[(i,
i + 1 mod n)]``) while every rank accumulates its Q block's attention
online, flash-attention style (fp32 running max, sum and output), so the
full sequence never meets on one device.

The ranks are the threads of ``parallel/sharded.run_ranks``, one a
device, and the rotation is an exchange of their tensors in a
:class:`~nnstreamer_tpu_torch.parallel.sharded.Group`: a device move,
which autograd differentiates like any other op.

Causal masking uses block indices: rank i attends to the block that
started on rank j fully when j < i, diagonally when j == i, not at all
when j > i (the ``-inf`` bias of the JAX package; such a block leaves
the running max, sum and output exactly as they were, so it is not
computed).
"""

from __future__ import annotations

import torch

from nnstreamer_tpu_torch.models.transformer import axis_group
# the canonical single-device reference lives with the flash kernel;
# re-exported for the unsharded path, as the JAX module does
from nnstreamer_tpu_torch.ops.flash_attention import (  # noqa: F401
    attention_reference,
)


def _block_attend(q, k, v, bias, m_prev, l_prev, o_prev, scale):
    """One online-softmax accumulation step (flash-style, numerically
    stable): returns updated (m, l, o). q/k/v ``[b, s, h, d]``; m, l
    ``[b, h, sq]``; o ``[b, h, sq, d]``."""
    s = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m_cur = torch.amax(s, dim=-1)                           # [b, h, q]
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new[..., None])
    l_corr = torch.exp(m_prev - m_new)
    l_new = l_prev * l_corr + torch.sum(p, dim=-1)
    o_corr = l_corr[..., None]
    o_new = o_prev * o_corr + torch.einsum("...hqk,...khd->...qhd",
                                           p, v).transpose(-3, -2)
    return m_new, l_new, o_new


def _diag_bias(sq: int, sk: int, device) -> torch.Tensor:
    """The diagonal block's causal bias, ``[1, 1, sq, sk]``: 0 on and
    below the diagonal, ``-inf`` above it."""
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(qi >= ki, zero, -torch.inf)[None, None]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = True
                   ) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis_name``.

    Called on each rank of ``axis_name`` inside ``run_ranks`` (the
    counterpart of ``shard_map``); outside a group of that axis (an axis
    of one device) the ring has one block. Shapes per rank: q/k/v
    ``[batch, seq_shard, heads, head_dim]``. Returns ``[batch,
    seq_shard, heads, head_dim]`` in ``q.dtype``."""
    g = axis_group(axis_name)
    group, my_idx = g if g is not None else (None, 0)
    axis_size = group.size if group is not None else 1
    scale = q.shape[-1] ** -0.5
    b, sq, h, d = q.shape

    m = torch.full((b, h, sq), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    qf = q.float()
    kb, vb = k, v
    for step in range(axis_size):
        src_idx = (my_idx - step) % axis_size  # block kb originated here
        # causal: a full block (src < mine) takes no bias (the JAX
        # package's zeros); a block from a later rank is fully masked and
        # would leave m, l and o as they are
        if not causal or src_idx < my_idx:
            m, l, o = _block_attend(qf, kb.float(), vb.float(), None,
                                    m, l, o, scale)
        elif src_idx == my_idx:
            m, l, o = _block_attend(
                qf, kb.float(), vb.float(),
                _diag_bias(sq, kb.shape[1], q.device), m, l, o, scale)
        if step + 1 < axis_size:
            # rotate K/V one rank forward (the last rotation is unused)
            kb, vb = group.shift(my_idx, kb, vb)
    out = o / torch.clamp(l, min=1e-30)[..., None]          # [b, h, sq, d]
    return out.transpose(1, 2).to(q.dtype)                 # [b, sq, h, d]
