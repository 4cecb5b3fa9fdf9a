"""Sparse 3D convolution over a 27-neighbour table.

Port of geopurify_tpu/ops/sparse_conv.py. ``out[i] = sum_k F[nbr[i, k]] @
W[k]`` with a zero sentinel row M for absent neighbours — MinkowskiEngine's
semantics — over the plain table (the tap scan, forward and backward), or,
in the forward of large scenes, over a ``ZStackTable``: 9 gathers of
3C-wide rows in place of 27 of C-wide ones, plus an exact residual for the
z-holes (sparse_conv.py:225-405).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from geopurify_tpu_torch.parallel.mesh import all_reduce_sum
from geopurify_tpu_torch.utils import profiling


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


# geopurify_tpu/ops/sparse_conv.py:225
class ZStackTable(NamedTuple):
    """The z-stacked 3^3 conv's tables. Lex-sorted voxels put (x, y, z-1)
    and (x, y, z+1) at the rows next to (x, y, z) whenever they exist, so
    the three dz taps of a kernel column (dx, dy) share one gather at the
    dz=0 tap's row of H = [f(z-pred) || f || f(z-succ)]. A column whose dz=0
    voxel is absent while a dz=+-1 one exists (a z-hole) is added by an
    exact per-tap residual; ``overflow``: a tap's residual exceeded its
    budget, and ``sparse_conv3`` runs the tap scan instead."""

    nbr: torch.Tensor        # [M, 27] the plain table
    t_mid: torch.Tensor      # [M, 9] dz=0 tap index per column (sentinel M)
    has_pred: torch.Tensor   # [M] row i-1 is i's z-predecessor
    has_succ: torch.Tensor   # [M] row i+1 is i's z-successor
    res_dst: torch.Tensor    # [18, B] destination rows (pad M)
    res_src: torch.Tensor    # [18, B] source rows (pad M: the zero sentinel)
    res_cnt: torch.Tensor    # [18] live edges per residual tap
    overflow: torch.Tensor   # [] bool


# residual tap ids: dz=-1 and dz=+1 of each of the 9 (dx, dy) columns
_Z_RES_TAPS = np.array([k for c in range(9) for k in (3 * c, 3 * c + 2)], dtype=np.int64)

# forward calls of ``sparse_conv3`` on a ZStackTable, by the route taken
ZSTACK_ROUTES = {"zstack": 0, "overflow": 0}


# geopurify_tpu/ops/sparse_conv.py:268
def build_zstack_table(
    voxel_coords: torch.Tensor,   # [M, 3] int, lex-sorted
    voxel_valid: torch.Tensor,    # [M] bool
    neighbor_idx: torch.Tensor,   # [M, 27] from build_neighbor_table
    res_budget: int = 16384,
) -> ZStackTable:
    """The z-stack tables from the 27-neighbour table, once a scene (shared
    by every 3^3 conv, like the table). Each residual tap keeps its
    live-while-mid-absent edges in row order, the first ``res_budget``."""
    M = neighbor_idx.shape[0]
    dev = neighbor_idx.device
    step = torch.tensor([0, 0, 1], dtype=voxel_coords.dtype, device=dev)
    adj = ((voxel_coords[1:] - voxel_coords[:-1] == step).all(-1)
           & voxel_valid[1:] & voxel_valid[:-1])
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    has_pred = torch.cat([no, adj])
    has_succ = torch.cat([adj, no])
    t_mid = neighbor_idx[:, 1::3]
    ks = torch.as_tensor(_Z_RES_TAPS, device=dev)
    mask = ((neighbor_idx[:, ks] < M)
            & (t_mid >= M).repeat_interleave(2, dim=1)).T       # [18, M]
    cnt = mask.sum(1)
    B = res_budget
    tap, row = profiling.nonzero(mask, as_tuple=True)              # tap-major, rows ascending
    rank = torch.arange(tap.shape[0], device=dev) - (torch.cumsum(cnt, 0) - cnt)[tap]
    keep = rank < B
    tap, row, rank = (profiling.masked(x, keep) for x in (tap, row, rank))
    dst = torch.full((18, B), M, dtype=neighbor_idx.dtype, device=dev)
    src = torch.full((18, B), M, dtype=neighbor_idx.dtype, device=dev)
    dst[tap, rank] = row.to(dst.dtype)
    src[tap, rank] = neighbor_idx[row, ks[tap]]
    return ZStackTable(neighbor_idx, t_mid, has_pred, has_succ, dst, src,
                       cnt.to(torch.int32), (cnt > B).any())


# geopurify_tpu/ops/sparse_conv.py:329
def _conv_zstack(features, zt: ZStackTable, weights, valid):
    """The z-stacked conv body: equal to ``_conv_core`` when ``zt.overflow``
    is false. The centre column (dx, dy) = (0, 0) is the identity on valid
    rows and runs as a direct matmul; each residual tap adds its edges,
    whose destinations are unique, by a gather and an indexed write."""
    M, Cin = features.shape
    Cout = weights.shape[2]
    zero = features.new_zeros((1, Cin))
    fm = torch.where(zt.has_pred[:, None], torch.cat([zero, features[:-1]]), 0.0)
    fp = torch.where(zt.has_succ[:, None], torch.cat([features[1:], zero]), 0.0)
    H = torch.cat([fm, features, fp], 1)
    H = torch.cat([H, H.new_zeros((1, 3 * Cin))])
    Wz = weights.reshape(9, 3 * Cin, Cout)
    t_mid = zt.t_mid.long()
    acc = _mm32(H[:M], Wz[4])
    for c in (0, 1, 2, 3, 5, 6, 7, 8):
        acc += _mm32(H[t_mid[:, c]], Wz[c])
    f_pad = torch.cat([features, zero])
    for t, n in enumerate(profiling.host_read(zt.res_cnt).tolist()):
        if n:
            dst = zt.res_dst[t, :n].long()
            acc[dst] = acc[dst] + _mm32(f_pad[zt.res_src[t, :n].long()],
                                        weights[int(_Z_RES_TAPS[t])])
    return torch.where(valid[:, None], acc, 0.0)


# geopurify_tpu/ops/sparse_conv.py:376
def sparse_conv3(
    features: torch.Tensor,      # [M, Cin]
    neighbor_idx,                # [M, K] int32 table (sentinel == M) or ZStackTable
    weights: torch.Tensor,       # [K, Cin, Cout]
    valid: torch.Tensor,         # [M] bool
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """With a ``ZStackTable`` the z-stacked forward runs, or the tap scan on
    its plain table where the residual overflowed (the JAX semantics; each
    call counted in ``ZSTACK_ROUTES``). The z-stack is forward only: the
    training step keeps the plain table and ``_Conv3``'s backward."""
    if isinstance(neighbor_idx, ZStackTable):
        zt = neighbor_idx
        if bool(profiling.host_read(zt.overflow)):
            ZSTACK_ROUTES["overflow"] += 1
            out = _conv_core(features, zt.nbr, weights, valid)
        else:
            ZSTACK_ROUTES["zstack"] += 1
            out = _conv_zstack(features, zt, weights, valid)
    else:
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
def masked_batch_stats(x: torch.Tensor, valid: torch.Tensor, group=None):
    """(mean, var) over the valid rows only, biased variance
    max(E[x^2] - E[x]^2, 0); differentiable. With ``group`` (a process
    group) the count and the two sums are summed over its ranks first, the
    backward summing their cotangents over it too: SyncBN."""
    v = valid[:, None].to(torch.float32)
    x32 = x.to(torch.float32)
    count = v.sum()
    s1 = (x32 * v).sum(0)
    s2 = (x32 * x32 * v).sum(0)
    if group is not None:
        C = s1.shape[0]
        summed = all_reduce_sum(torch.cat([count[None], s1, s2]), group)
        count, s1, s2 = summed[0], summed[1: C + 1], summed[C + 1:]
    count = torch.clamp(count, min=1.0)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    return mean, var
