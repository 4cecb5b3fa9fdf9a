"""K1: the banded-window matmul — the 19x smoothing core.

Port of the TPU kernel geopurify_tpu/ops/pallas_band.py::banded_window_matmul
(:81-120). For each tile ``t`` of ``row_tile`` rows:

    out[rows of t] = S[rows of t, :band] @ F[starts[t] : starts[t] + band, :C]

in f32 from bf16 ``S`` and ``F``, for any C up to 512 (the class counts of
logit-space smoothing and the 512 channels of feature-space smoothing). On
a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/band_matmul.cu`` or raises: up to 32 columns the WMMA kernel, above
that the wgmma + TMA kernel at the column count ``_plan`` picks (see the
source note). On a CPU tensor it runs ``banded_window_matmul_ref``, the
plain gather + batched-matmul form of geopurify_tpu/ops/pooling.py:488-495.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from geopurify_tpu_torch.utils.profiling import hand_kernel

_KERNEL_ROWS = 128        # rows a block, and the output's row padding
_MAX_COLS = 512
_WMMA_COLS = 32           # C <= 32: the WMMA kernel, one block per 128 rows
_SLAB_COLS = 256          # the widest wgmma tile; a wider C runs as slabs
_CLUSTER_ROWS = 256       # two blocks of one cluster share a window

# The wgmma kernel's column counts (multiples of 8, the wgmma N step), each
# at most 1.25x the smallest C it serves, and exact at the presets' class
# counts 40, 80, 160 and 200; not 112 or 120, for which ptxas spills.
# csrc/wgmma_bf16.cuh is generated from this tuple
# (python -m geopurify_tpu_torch.utils.gen_wgmma).
WGMMA_COLS = (40, 48, 56, 64, 80, 96, 104, 128, 144, 160, 200, 232, 256)


class Plan(NamedTuple):
    """How the wrapper launches K1 for C columns."""
    kernel: str     # "wmma" (C <= 32) or "wgmma"
    bn: int         # columns a block computes
    ldf: int        # row stride of the output: slabs * bn
    slabs: int      # column slabs of bn, side by side
    cluster: int    # blocks a cluster (2: one F window multicast to both)


def _plan(C: int, row_tile: int) -> Plan:
    """The instantiation, tile width, padding, slabs and cluster for C.

    C <= 32 runs the WMMA kernel on 32 columns. Above that C is split into
    ceil(C / 256) slabs of equal width, and each slab is padded to the
    smallest entry of ``WGMMA_COLS`` that holds it: at most 25% more
    columns than ceil(C / slabs). Two blocks of 128 rows form a cluster
    that shares each F chunk when both lie in one row tile
    (``row_tile % 256 == 0``)."""
    if not 0 < C <= _MAX_COLS:
        raise ValueError(f"C={C}: the kernel takes 1 to {_MAX_COLS} columns")
    if C <= _WMMA_COLS:
        return Plan("wmma", _WMMA_COLS, _WMMA_COLS, 1, 1)
    slabs = -(-C // _SLAB_COLS)
    bn = next(b for b in WGMMA_COLS if b >= -(-C // slabs))
    cluster = 2 if row_tile % _CLUSTER_ROWS == 0 else 1
    return Plan("wgmma", bn, slabs * bn, slabs, cluster)


def banded_window_matmul_ref(S: torch.Tensor, starts: torch.Tensor,
                             f: torch.Tensor, band: int,
                             row_tile: int = 2048) -> torch.Tensor:
    """Plain version: gather the [n_t, band, C] windows (rows clamped to
    M - 1, as pooling.py:476-479 does) and one batched matmul, bf16 inputs
    with f32 accumulation. ``S`` is [R, band]; returns [R, C] f32."""
    R = S.shape[0]
    M = f.shape[0]
    n_t = -(-R // row_tile)
    Rp = n_t * row_tile
    S3 = torch.nn.functional.pad(S, (0, 0, 0, Rp - R)).reshape(n_t, row_tile, band)
    win = torch.clamp(
        starts.long()[:, None]
        + torch.arange(band, device=f.device, dtype=torch.int64)[None],
        max=M - 1)
    FW = f[win]                                           # [n_t, band, C]
    out = torch.bmm(S3.float(), FW.float())               # exact bf16 products
    return out.reshape(Rp, -1)[:R]


def banded_window_matmul_work(R: int, M: int, band: int, C: int, n_t: int):
    """(operations, bytes) of one call: 2 R band C multiply-adds; S [R, band]
    and F [M, C] bf16 and the n_t int32 starts read once, out [R, C] f32
    written once."""
    return 2.0 * R * band * C, R * band * 2 + M * C * 2 + n_t * 4 + R * C * 4


def banded_window_matmul(S: torch.Tensor, starts: torch.Tensor,
                         f: torch.Tensor, band: int,
                         row_tile: int = 2048) -> torch.Tensor:
    """``out[R, C]`` f32. ``S`` [R, band] bf16, ``starts`` [ceil(R/row_tile)]
    int32 (the banded operator keeps each a multiple of 8 with
    start + band <= M), ``f`` [M, C] bf16 with C <= 512. Under
    ``utils.profiling.compiled_costs`` it counts
    ``banded_window_matmul_work`` on either route."""
    R, (M, C) = S.shape[0], f.shape
    with hand_kernel(*banded_window_matmul_work(R, M, band, C, -(-R // row_tile))):
        if not S.is_cuda:
            return banded_window_matmul_ref(S, starts, f, band, row_tile)
        return _launch(S, starts, f, band, row_tile)


def _launch(S, starts, f, band: int, row_tile: int) -> torch.Tensor:
    R, C = S.shape[0], f.shape[1]
    M = f.shape[0]
    if S.dtype != torch.bfloat16 or f.dtype != torch.bfloat16:
        raise TypeError(f"S and f must be bfloat16, got {S.dtype}, {f.dtype}")
    if S.shape[1] != band or band % 8:
        raise ValueError(f"S must be [R, band] with band % 8 == 0, got "
                         f"{tuple(S.shape)}, band={band}")
    if row_tile % _KERNEL_ROWS:
        raise ValueError(f"row_tile={row_tile} must be a multiple of {_KERNEL_ROWS}")
    plan = _plan(C, row_tile)
    n_t = -(-R // row_tile)
    if starts.shape != (n_t,):
        raise ValueError(f"starts must be [{n_t}], got {tuple(starts.shape)}")
    if not (f.is_cuda and starts.is_cuda and S.device == f.device == starts.device):
        raise ValueError("S, starts and f must lie on one CUDA device")
    S = S.contiguous()
    if S.data_ptr() % 16:                   # TMA reads from 16-byte aligned rows
        S = S.clone()
    starts = starts.to(torch.int32).contiguous()
    f = f.contiguous()
    Rpad = -(-R // _KERNEL_ROWS) * _KERNEL_ROWS
    out = torch.empty((Rpad, plan.ldf), dtype=torch.float32, device=S.device)
    stream = torch.cuda.current_stream(S.device).cuda_stream
    lib = _lib()
    if plan.kernel == "wmma":
        fp = f if C == plan.ldf else torch.nn.functional.pad(f, (0, plan.ldf - C))
        err = lib.band_matmul_wmma(S.data_ptr(), starts.data_ptr(), fp.data_ptr(),
                                   out.data_ptr(), R, M, band, row_tile, stream)
    else:
        # TMA reads F's rows at 16-byte aligned strides: C a multiple of 8
        if C % 8:
            f = torch.nn.functional.pad(f, (0, -C % 8))
        elif f.data_ptr() % 16:
            f = f.clone()
        err = lib.band_matmul_wgmma(
            S.data_ptr(), starts.data_ptr(), f.data_ptr(), out.data_ptr(), R, M,
            f.shape[1], band, row_tile, plan.bn, plan.ldf, plan.cluster, stream)
    if err != 0:
        raise RuntimeError(f"band_matmul launch failed: CUDA error {err}")
    banded_window_matmul.launches += 1
    return out[:R, :C]


banded_window_matmul.launches = 0


def _lib():
    from geopurify_tpu_torch.utils.cuda_build import load

    lib = load("band_matmul")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.band_matmul_wmma.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.band_matmul_wgmma.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.band_matmul_wmma.restype = lib.band_matmul_wgmma.restype = ctypes.c_int
        lib._typed = True
    return lib
