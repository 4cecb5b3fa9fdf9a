"""Kernel K1 on the card: the CUDA kernel against its plain PyTorch version
at awkward shapes (ragged row counts, C below 32, a band that is not a
multiple of the kernel's chunk, windows clamped at the last row), and the
wrapper's refusals. Marked ``cuda``; skipped where no card is present. Run
on a machine with one: ``python -m pytest -m cuda tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

from geopurify_tpu_torch.ops.band import banded_window_matmul, banded_window_matmul_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K1 kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("R,M,band,C,row_tile", [
    (700, 700, 256, 19, 128),      # ragged last block, C < 32
    (1000, 1200, 200, 32, 256),    # band % 64 != 0, R < M
    (4096, 4096, 1024, 1, 2048),   # one column
])
def test_k1_matches_plain_version(card, R, M, band, C, row_tile):
    g = torch.Generator(device=card).manual_seed(R + C)
    n_t = -(-R // row_tile)
    S = torch.randn((R, band), generator=g, device=card).to(torch.bfloat16)
    f = torch.randn((M, C), generator=g, device=card).to(torch.bfloat16)
    starts = torch.randint(0, M - band + 1, (n_t,), generator=g, device=card)
    starts = (starts // 8 * 8).to(torch.int32)
    starts[-1] = M - 8           # past the contract: rows clamp to M - 1
    n0 = banded_window_matmul.launches
    out = banded_window_matmul(S, starts, f, band=band, row_tile=row_tile)
    torch.cuda.synchronize()
    assert banded_window_matmul.launches == n0 + 1
    ref = banded_window_matmul_ref(S, starts, f, band=band, row_tile=row_tile)
    assert out.shape == ref.shape == (R, C) and out.dtype == torch.float32
    # f32 sums of exact bf16 products, in another order
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4 * ref.abs().max().item())


def test_k1_refuses_what_it_does_not_take(card):
    S = torch.zeros((256, 128), dtype=torch.bfloat16, device=card)
    starts = torch.zeros((1,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        banded_window_matmul(S, starts, torch.zeros((256, 33), dtype=torch.bfloat16,
                                                    device=card), band=128, row_tile=2048)
    with pytest.raises(TypeError):
        banded_window_matmul(S.float(), starts, torch.zeros((256, 8), device=card),
                             band=128, row_tile=2048)
    with pytest.raises(ValueError):
        banded_window_matmul(S, starts, torch.zeros((256, 8), dtype=torch.bfloat16,
                                                    device=card), band=128, row_tile=100)
