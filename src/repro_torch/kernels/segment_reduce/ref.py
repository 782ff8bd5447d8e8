"""Plain PyTorch segment sum: ``index_add_`` into float64.

On the CPU ``index_add_`` adds in entry order, so the result is
bit-equal to ``np.bincount`` (column by column for ``(K, E)`` values);
on the card it uses atomics and sums in no fixed order.  Ids outside
``[0, num_segments)`` are dropped.  They are redirected to segment 0
with a value of ``+0.0``, which leaves every sum unchanged bit for bit
(a sum that starts at ``+0.0`` never holds ``-0.0``), and keeps the
function free of host syncs.
"""

from __future__ import annotations

import torch


def segment_sum_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """``out[..., s] = sum(values[..., segment_ids == s])`` over ``(E,)``
    or ``(K, E)`` values, float64."""
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    out = torch.zeros((*values.shape[:-1], num_segments),
                      dtype=torch.float64, device=values.device)
    return out.index_add_(-1, torch.where(keep, segment_ids, 0),
                          torch.where(keep, values.to(torch.float64), 0.0))
