"""Space-filling-curve codes for integer voxel coordinates.

Port of geopurify_tpu/ops/morton.py. Bit-exact int32 against the JAX
package (tests/test_torch_port_ops.py).
"""

from __future__ import annotations

import torch


# geopurify_tpu/ops/morton.py:14
def part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


# geopurify_tpu/ops/morton.py:24
def morton_code(coords: torch.Tensor, order: int = 0) -> torch.Tensor:
    """30-bit Morton code of non-negative int coords (clamped to 10 bits an
    axis); ``order`` 0 = (x, y, z), 1 = (y, x, z) — the z / z-trans pair."""
    c = torch.clamp(coords, 0, (1 << 10) - 1).to(torch.int32)
    if order == 1:
        c = c[:, [1, 0, 2]]
    return part1by2(c[:, 0]) | (part1by2(c[:, 1]) << 1) | (part1by2(c[:, 2]) << 2)


# geopurify_tpu/ops/morton.py:40
def hilbert_code(coords: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """3-D Hilbert index of non-negative int coords (clamped to ``bits``/axis),
    Skilling's transpose algorithm, vectorized over rows — the same
    operation order as the JAX version, so the codes match bit for bit."""
    c = torch.clamp(coords, 0, (1 << bits) - 1).to(torch.int32)
    x0, x1, x2 = c[:, 0], c[:, 1], c[:, 2]
    zero = torch.zeros_like(x0)

    q = 1 << (bits - 1)
    while q > 1:
        p = q - 1
        for xi in range(3):
            x = (x0, x1, x2)[xi]
            has = (x & q) != 0
            t = torch.where(has, zero, (x0 ^ x) & p)
            x0 = torch.where(has, x0 ^ p, x0 ^ t)
            if xi == 0:
                continue
            x_new = x ^ t
            if xi == 1:
                x1 = x_new
            else:
                x2 = x_new
        q >>= 1

    x1 = x1 ^ x0
    x2 = x2 ^ x1
    t = torch.zeros_like(x0)
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((x2 & q) != 0, t ^ (q - 1), t)
        q >>= 1
    x0, x1, x2 = x0 ^ t, x1 ^ t, x2 ^ t
    return (part1by2(x0) << 2) | (part1by2(x1) << 1) | part1by2(x2)
