"""Multi-scale deformable attention (Deformable-DETR style) in plain torch.

Port of geopurify_tpu/ops/ms_deform_attn.py, which is XLA (not Pallas) in
the JAX package. Semantics as there:
- ``value``: [B, L, H, D] flattened multi-level values (L = sum of
  H_l * W_l), H heads, D head dim;
- ``spatial_shapes``: (H_l, W_l) per level;
- ``sampling_locations``: [B, Q, H, levels, P, 2], (x, y) normalized to
  [0, 1], sampled bilinearly with align_corners=False and zero padding;
- ``attention_weights``: [B, Q, H, levels, P];
- output [B, Q, H * D], accumulated in f32 and cast to ``value``'s dtype.

The JAX body loops levels x heads x points; here each level is one
``F.grid_sample`` over every (batch, head) image and every (query, point)
location, which autograd differentiates with respect to the values, the
locations and the weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


# geopurify_tpu/ops/ms_deform_attn.py:29
def bilinear_sample(value: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample ``value`` [Hl, Wl, C] at continuous pixel coords (x, y) [N]
    (pixel centres at integer + 0.5 - 0.5, i.e. grid_sample's
    align_corners=False); zero outside. Returns [N, C]."""
    Hl, Wl, C = value.shape
    grid = torch.stack([(2 * x + 1) / Wl - 1, (2 * y + 1) / Hl - 1], -1)
    out = F.grid_sample(value.permute(2, 0, 1)[None], grid[None, None].to(value.dtype),
                        mode="bilinear", padding_mode="zeros", align_corners=False)
    return out[0, :, 0].T


# geopurify_tpu/ops/ms_deform_attn.py:56
def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    B, L, H, D = value.shape
    _, Q, _, n_levels, P, _ = sampling_locations.shape
    assert n_levels == len(spatial_shapes)
    v32 = value.to(torch.float32)
    # [B, Q, H, lvl, P, 2] in [0, 1] -> [B*H, lvl, Q, P, 2] in [-1, 1]
    grid = (2 * sampling_locations.to(torch.float32) - 1).permute(0, 2, 3, 1, 4, 5)
    grid = grid.reshape(B * H, n_levels, Q, P, 2)
    w = attention_weights.to(torch.float32).permute(0, 2, 3, 1, 4)
    w = w.reshape(B * H, 1, n_levels, Q, P)
    out = None
    off = 0
    for lvl, (hl, wl) in enumerate(spatial_shapes):
        v = v32[:, off:off + hl * wl].reshape(B, hl, wl, H, D)
        v = v.permute(0, 3, 4, 1, 2).reshape(B * H, D, hl, wl)
        s = F.grid_sample(v, grid[:, lvl], mode="bilinear", padding_mode="zeros",
                          align_corners=False)                 # [B*H, D, Q, P]
        term = (s * w[:, :, lvl]).sum(-1)                      # [B*H, D, Q]
        out = term if out is None else out + term
        off += hl * wl
    out = out.reshape(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)
    return out.to(value.dtype)
