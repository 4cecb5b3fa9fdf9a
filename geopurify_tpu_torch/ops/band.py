"""K1: the banded-window matmul — the 19x smoothing core.

Port of the TPU kernel geopurify_tpu/ops/pallas_band.py::banded_window_matmul
(:81-120). For each tile ``t`` of ``row_tile`` rows:

    out[rows of t] = S[rows of t, :band] @ F[starts[t] : starts[t] + band, :C]

in f32 from bf16 ``S`` and ``F``. On a CUDA tensor the wrapper launches the
hand-written Hopper kernel ``csrc/band_matmul.cu`` (bytes-bound: it reads
each S element once; see the source note) or raises; on a CPU tensor it runs
``banded_window_matmul_ref``, the plain gather + batched-matmul form of
geopurify_tpu/ops/pooling.py:488-495.
"""

from __future__ import annotations

import ctypes

import torch

_KERNEL_ROWS = 128        # rows per CUDA block (BM in the source)
_KERNEL_COLS = 32         # the kernel's fixed column count (C <= 32)


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


def banded_window_matmul(S: torch.Tensor, starts: torch.Tensor,
                         f: torch.Tensor, band: int,
                         row_tile: int = 2048) -> torch.Tensor:
    """``out[R, C]`` f32. ``S`` [R, band] bf16, ``starts`` [ceil(R/row_tile)]
    int32 (the banded operator keeps each a multiple of 8 with
    start + band <= M), ``f`` [M, C] bf16 with C <= 32."""
    if not S.is_cuda:
        return banded_window_matmul_ref(S, starts, f, band, row_tile)
    R, C = S.shape[0], f.shape[1]
    M = f.shape[0]
    if S.dtype != torch.bfloat16 or f.dtype != torch.bfloat16:
        raise TypeError(f"S and f must be bfloat16, got {S.dtype}, {f.dtype}")
    if S.shape[1] != band or band % 8:
        raise ValueError(f"S must be [R, band] with band % 8 == 0, got "
                         f"{tuple(S.shape)}, band={band}")
    if C > _KERNEL_COLS:
        raise ValueError(f"C={C} > {_KERNEL_COLS} columns")
    if row_tile % _KERNEL_ROWS:
        raise ValueError(f"row_tile={row_tile} must be a multiple of {_KERNEL_ROWS}")
    n_t = -(-R // row_tile)
    if starts.shape != (n_t,):
        raise ValueError(f"starts must be [{n_t}], got {tuple(starts.shape)}")
    if not (f.is_cuda and starts.is_cuda and S.device == f.device == starts.device):
        raise ValueError("S, starts and f must lie on one CUDA device")
    S = S.contiguous()
    starts = starts.to(torch.int32).contiguous()
    fp = f if C == _KERNEL_COLS else torch.nn.functional.pad(f, (0, _KERNEL_COLS - C))
    fp = fp.contiguous()
    Rpad = -(-R // _KERNEL_ROWS) * _KERNEL_ROWS
    out = torch.empty((Rpad, _KERNEL_COLS), dtype=torch.float32, device=S.device)
    lib = _lib()
    err = lib.band_matmul(
        S.data_ptr(), starts.data_ptr(), fp.data_ptr(), out.data_ptr(),
        R, M, band, row_tile, torch.cuda.current_stream(S.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_matmul launch failed: CUDA error {err}")
    banded_window_matmul.launches += 1
    return out[:R, :C]


banded_window_matmul.launches = 0


def _lib():
    from geopurify_tpu_torch.utils.cuda_build import load

    lib = load("band_matmul")
    if not getattr(lib, "_typed", False):
        lib.band_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.band_matmul.restype = ctypes.c_int
        lib._typed = True
    return lib
