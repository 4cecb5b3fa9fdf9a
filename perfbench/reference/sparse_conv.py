"""Sparse 3D convolution of the plain reference over a 27-neighbour table: a
frozen copy of the port's ``ops/sparse_conv.py`` tap scan. ``out[i] =
sum_k F[nbr[i, k]] @ W[k]`` with a zero sentinel row M for absent
neighbours; the port's z-stacked forward of large scenes is left out.
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


def _mm32(a, b):
    """a @ b with f32 accumulation (bf16 operands are exact in f32)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _center(K: int):
    # the centre tap of a full 3^3 / 5^3 stencil is the identity on valid rows
    return K // 2 if K in (27, 125) else None


# geopurify_tpu/ops/sparse_conv.py:116 (_conv_taps) + :160 (_conv_core)
def _conv_core(features, neighbor_idx, weights, valid):
    M, Cin = features.shape
    K = weights.shape[0]
    f_pad = torch.cat([features, features.new_zeros((1, Cin))], dim=0)
    nbr = neighbor_idx.long()
    center = _center(K)
    if center is None:
        acc = torch.zeros((M, weights.shape[2]), dtype=torch.float32,
                          device=features.device)
    else:
        acc = _mm32(features, weights[center])
    for k in range(K):
        if k != center:
            acc = acc + _mm32(f_pad[nbr[:, k]], weights[k])
    return torch.where(valid[:, None], acc, 0.0)


class _Conv3(torch.autograd.Function):
    """The tap-scan conv with a backward that re-gathers: autograd of the
    plain loop would save every gathered [M, Cin] tap (26 taps x 9 convs x
    134 MB at M = 65536 for the student's training step). This saves only
    the input and the table; dX scatters back through ``index_add_``. The
    JAX package gets the same from XLA (sparse_conv.py:160, custom VJP)."""

    @staticmethod
    def forward(ctx, features, neighbor_idx, weights, valid):
        ctx.save_for_backward(features, neighbor_idx, weights, valid)
        return _conv_core(features, neighbor_idx, weights, valid)

    @staticmethod
    def backward(ctx, grad):
        features, neighbor_idx, weights, valid = ctx.saved_tensors
        M, Cin = features.shape
        K = weights.shape[0]
        g = torch.where(valid[:, None], grad.to(torch.float32), 0.0)
        nbr = neighbor_idx.long()
        f_pad = torch.cat([features, features.new_zeros((1, Cin))], dim=0)
        need_x, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        dx = torch.zeros((M + 1, Cin), dtype=torch.float32, device=g.device) if need_x else None
        dw = torch.empty(weights.shape, dtype=torch.float32, device=g.device) if need_w else None
        center = _center(K)
        for k in range(K):
            if need_w:
                tap = features if k == center else f_pad[nbr[:, k]]
                dw[k] = _mm32(tap.T, g)
            if need_x:
                gx = _mm32(g, weights[k].T)
                if k == center:
                    dx[:M] += gx
                else:
                    dx.index_add_(0, nbr[:, k], gx)
        return (dx[:M].to(features.dtype) if need_x else None, None,
                dw.to(weights.dtype) if need_w else None, None)


def sparse_conv3(
    features: torch.Tensor,      # [M, Cin]
    neighbor_idx,                # [M, K] int32 table (sentinel == M)
    weights: torch.Tensor,       # [K, Cin, Cout]
    valid: torch.Tensor,         # [M] bool
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The tap scan over the plain table, forward and backward."""
    out = _Conv3.apply(features, neighbor_idx, weights, valid)
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


# geopurify_tpu/ops/sparse_conv.py:420-436
def masked_batch_stats(x: torch.Tensor, valid: torch.Tensor):
    """(mean, var) over the valid rows only, biased variance
    max(E[x^2] - E[x]^2, 0); differentiable."""
    v = valid[:, None].to(torch.float32)
    x32 = x.to(torch.float32)
    count = v.sum()
    s1 = (x32 * v).sum(0)
    s2 = (x32 * x32 * v).sum(0)
    count = torch.clamp(count, min=1.0)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    return mean, var
