"""Sparse 3D convolution over a 27-neighbour table.

Port of geopurify_tpu/ops/sparse_conv.py (the plain-table path; the
z-stacked large-M path, sparse_conv.py:225-375, is a TPU layout
optimisation gated on M >= 131072 and is not part of this port).
``out[i] = sum_k F[nbr[i, k]] @ W[k]`` with a zero sentinel row M for
absent neighbours — MinkowskiEngine's semantics.
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch


# geopurify_tpu/ops/sparse_conv.py:34
def kernel_offsets_3d(kernel_size: int = 3) -> np.ndarray:
    """Kernel offset enumeration, x-major (dx slowest, dz fastest): [K, 3]
    int32 — the same product order as the JAX package (the student's
    weights are stored per tap in this order)."""
    r = range(-(kernel_size // 2), kernel_size // 2 + 1)
    return np.array(list(itertools.product(r, r, r)), dtype=np.int32)


# geopurify_tpu/ops/sparse_conv.py:47
def build_neighbor_table(
    voxel_coords: torch.Tensor,  # [M, 3] int, >= 0
    voxel_valid: torch.Tensor,   # [M] bool
    kernel_size: int = 3,
) -> torch.Tensor:
    """Neighbour table [M, K] int32; entry == M where the neighbour is absent
    (and on every tap of an invalid row). One sorted-key searchsorted per
    tap over int64 linear keys."""
    M = voxel_coords.shape[0]
    dev = voxel_coords.device
    offsets = torch.as_tensor(kernel_offsets_3d(kernel_size), device=dev,
                              dtype=torch.int64)
    c = voxel_coords.to(torch.int64)
    maxc = torch.where(voxel_valid[:, None], c, 0).max(dim=0).values
    spans = maxc + 3

    def lin(x):
        return (x[..., 0] * spans[1] + x[..., 1]) * spans[2] + x[..., 2]

    big = torch.iinfo(torch.int64).max
    keys = torch.where(voxel_valid, lin(c + 1), big)
    skeys, order = torch.sort(keys, stable=True)
    targets = lin(c[None, :, :] + 1 + offsets[:, None, :])       # [K, M]
    pos = torch.searchsorted(skeys, targets.reshape(-1)).reshape(targets.shape)
    pos_c = pos.clamp(max=M - 1)
    hit = (skeys[pos_c] == targets) & (pos < M) & voxel_valid[None, :]
    table = torch.where(hit, order[pos_c], M)
    return table.T.contiguous().to(torch.int32)


# geopurify_tpu/ops/sparse_conv.py:116 (_conv_taps) + :160 (_conv_core)
def _conv_core(features, neighbor_idx, weights, valid):
    M, Cin = features.shape
    K = weights.shape[0]
    f_pad = torch.cat([features, features.new_zeros((1, Cin))], dim=0)
    nbr = neighbor_idx.long()
    # the centre tap of a full 3^3 / 5^3 stencil is the identity on valid
    # rows: one direct matmul, then the other taps in product order
    center = K // 2 if K in (27, 125) else None
    if center is None:
        acc = torch.zeros((M, weights.shape[2]), dtype=torch.float32,
                          device=features.device)
        taps = range(K)
    else:
        acc = _mm32(features, weights[center])
        taps = [k for k in range(K) if k != center]
    for k in taps:
        acc = acc + _mm32(f_pad[nbr[:, k]], weights[k])
    return torch.where(valid[:, None], acc, 0.0)


def _mm32(a, b):
    """a @ b with f32 accumulation (bf16 operands are exact in f32)."""
    return a.to(torch.float32) @ b.to(torch.float32)


# geopurify_tpu/ops/sparse_conv.py:376
def sparse_conv3(
    features: torch.Tensor,      # [M, Cin]
    neighbor_idx: torch.Tensor,  # [M, K] int32 (sentinel == M)
    weights: torch.Tensor,       # [K, Cin, Cout]
    valid: torch.Tensor,         # [M] bool
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    out = _conv_core(features, neighbor_idx, weights, valid)
    if bias is not None:
        out = torch.where(valid[:, None], out + bias[None, :].float(), 0.0)
    return out.to(features.dtype)


# geopurify_tpu/ops/sparse_conv.py:407
def sparse_conv1(
    features: torch.Tensor,   # [M, Cin]
    weight: torch.Tensor,     # [Cout, Cin] (torch Linear layout)
    valid: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """1x1x1 sparse conv == plain per-voxel matmul."""
    out = _mm32(features, weight.T)
    if bias is not None:
        out = out + bias[None, :].float()
    return torch.where(valid[:, None], out, 0.0).to(features.dtype)
