"""The yardstick's peaks and the hand kernels' operation and byte counts.

Every share is taken against one NVIDIA H100 SXM's dense bf16 peak and its
HBM3 rate (NVIDIA's data sheet, at the full 700 W), in every cell; the
card's power limit is printed beside each run. The kernels' counts are
copies of the port's ``ops/band.py::banded_window_matmul_work`` and
``ops/infonce.py::info_nce_work``: each input read once and each output
written once.
"""

from __future__ import annotations

BF16_FLOPS = 989e12          # dense bf16 tensor-core operations a second
HBM_BYTES_PER_S = 3.35e12    # HBM3 bytes a second


def bound_s(flops: float, bytes_: float) -> float:
    """The least time the chip could take: operations or bytes at peak."""
    return max(flops / BF16_FLOPS, bytes_ / HBM_BYTES_PER_S)


def k1_work(R: int, M: int, band: int, C: int, n_t: int):
    """(operations, bytes) of one K1 call: 2 R band C multiply-adds; S
    [R, band] and F [M, C] bf16 and the n_t int32 window starts read once,
    out [R, C] f32 written once."""
    return 2.0 * R * band * C, R * band * 2 + M * C * 2 + n_t * 4 + R * C * 4


def k2_work(A: int, NEG: int, E: int, backward: bool):
    """(operations, bytes) of one K2 call: a, p, n f32 and the valid flags
    in, the per-anchor loss out (forward), or the loss gradient in and da,
    dp, dn out (backward); ~4 E operations a row for its norm and its dot
    with the anchor (NEG + 2 rows), ~3x that backward."""
    emb = 4 * (2 * A * E + A * NEG * E)
    bytes_ = emb + A + (4 * A + emb if backward else 4 * A)
    return 4.0 * E * (NEG + 2) * A * (3 if backward else 1), bytes_
