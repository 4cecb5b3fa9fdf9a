"""Segment reductions of the plain reference: a frozen copy of the port's
``ops/segment.py``.

Segment reductions with static segment counts.

Port of geopurify_tpu/ops/segment.py. Ids outside [0, num_segments) drop —
that is how padded rows (id == num_segments) fall out of the reduction.
"""

from __future__ import annotations

import torch


# geopurify_tpu/ops/segment.py:15
def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets; out-of-range ids drop."""
    ids = segment_ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    ids = torch.where(ok, ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    out.index_add_(0, ids, data)
    return out[:num_segments]


# geopurify_tpu/ops/segment.py:47
def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, eps: float = 1e-12) -> torch.Tensor:
    """Mean of ``data`` rows per segment. Empty segments return 0."""
    totals = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones((data.shape[0],), dtype=data.dtype, device=data.device)
    counts = segment_sum(ones, segment_ids, num_segments)
    return totals / torch.clamp(counts, min=eps)[:, None]
