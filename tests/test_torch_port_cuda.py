"""Kernels K1 and K2 on the card, each against its plain PyTorch version.

K1 at awkward shapes: ragged row counts, C below 32, a band that is not a
multiple of the kernel's chunk, windows clamped at the last row; every
column instantiation (C = 64, 100, 200 and 512, the last as two column
slabs of 256); and one S of more than 2^31 elements, whose row offsets need
64 bits. K2 (fused
InfoNCE forward and backward) at E = 8, 16, 128, NEG from 1 to 63
and anchor counts that are not a multiple of the warps of a block. Then
each wrapper's refusals. Marked ``cuda``; skipped where no card is present.
Run on a machine with one: ``python -m pytest -m cuda tests/test_torch_port_cuda.py``.
"""

import pytest
import torch

from geopurify_tpu_torch.ops.band import banded_window_matmul, banded_window_matmul_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("R,M,band,C,row_tile", [
    (700, 700, 256, 19, 128),      # ragged last block, C < 32
    (1000, 1200, 200, 32, 256),    # band % 64 != 0, R < M
    (4096, 4096, 1024, 1, 2048),   # one column
    (3000, 4000, 512, 64, 256),    # the 64-column instantiation, ragged rows
    (1500, 2048, 256, 100, 256),   # the 128-column instantiation
    (2048, 4096, 1024, 200, 1024), # 256 columns a block (scannet200's classes)
    (1100, 2048, 520, 512, 512),   # two column slabs (feature space), ragged
    (262144, 262144, 8200, 19, 2048),  # R * band > 2^31
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
        banded_window_matmul(S, starts, torch.zeros((256, 513), dtype=torch.bfloat16,
                                                    device=card), band=128, row_tile=2048)
    with pytest.raises(TypeError):
        banded_window_matmul(S.float(), starts, torch.zeros((256, 8), device=card),
                             band=128, row_tile=2048)
    with pytest.raises(ValueError):
        banded_window_matmul(S, starts, torch.zeros((256, 8), dtype=torch.bfloat16,
                                                    device=card), band=128, row_tile=100)


# ---------------------------------------------------------------------------
# Kernel K2: the fused InfoNCE forward and backward
# ---------------------------------------------------------------------------

from geopurify_tpu_torch.ops.infonce import (  # noqa: E402
    info_nce_bwd,
    info_nce_fwd,
    info_nce_loss_fused,
    per_anchor_grads_ref,
    per_anchor_loss_ref,
)


def _k2_inputs(card, A, NEG, E, seed, p_valid=0.8, upstream=False):
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.randn((A, E), generator=g, device=card)
    p = torch.randn((A, E), generator=g, device=card)
    n = torch.randn((A, NEG, E), generator=g, device=card)
    valid = torch.rand((A,), generator=g, device=card) < p_valid
    if upstream:
        return a, p, n, valid, torch.rand((A,), generator=g, device=card)
    return a, p, n, valid


@pytest.mark.parametrize("A,NEG,E", [
    (37, 1, 8),          # A not a multiple of the 8 warps of a block, one negative
    (1001, 7, 16),       # masked lanes (E < 32), ragged last block
    (515, 63, 128),      # the path's NEG and E (16-byte loads)
])
def test_k2_matches_plain_version(card, A, NEG, E):
    # the plain versions' einsums in full f32 (no TF32), as the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    a, p, n, valid, g = _k2_inputs(card, A, NEG, E, seed=A + NEG + E, upstream=True)
    T = 0.07
    n0, n1 = info_nce_fwd.launches, info_nce_bwd.launches
    per = info_nce_fwd(a, p, n, valid, T)
    da, dp, dn = info_nce_bwd(a, p, n, valid, T, g)
    torch.cuda.synchronize()
    assert (info_nce_fwd.launches, info_nce_bwd.launches) == (n0 + 1, n1 + 1)
    # f32 sums over E and over the negatives in another order than the
    # plain version's einsum / logsumexp
    torch.testing.assert_close(per, per_anchor_loss_ref(a, p, n, valid, T),
                               rtol=1e-5, atol=1e-5)
    # g is of order 1, not the masked mean's 1/sum(valid), so the gradients
    # are ~sum(valid) times those of tests/test_pallas_infonce.py, whose atol
    # 1e-6 is ~1e-4 of its gradients' scale. Elements near 0 come out of the
    # cancellation in x - (x.x^) x^ and carry f32 rounding of order 1e-6 of
    # the scale in either version, so atol is 1e-5 of each output's own scale
    for got, ref in zip((da, dp, dn), per_anchor_grads_ref(a, p, n, valid, T, g)):
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=1e-5 * ref.abs().max().item())


def test_k2_autograd_and_all_invalid(card):
    a, p, n, valid = _k2_inputs(card, 96, 7, 16, seed=5)
    xs = [x.clone().requires_grad_() for x in (a, p, n)]
    loss = info_nce_loss_fused(*xs, valid, 0.07)
    loss.backward()
    ys = [x.detach().cpu().requires_grad_() for x in (a, p, n)]
    ref = info_nce_loss_fused(*ys, valid.cpu(), 0.07)
    ref.backward()
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)
    for x, y in zip(xs, ys):
        torch.testing.assert_close(x.grad.cpu(), y.grad, rtol=2e-4, atol=1e-6)
    for x in xs:
        x.grad = None
    dead = info_nce_loss_fused(*xs, torch.zeros_like(valid), 0.07)
    dead.backward()
    assert dead.item() == 0.0
    assert all(torch.count_nonzero(x.grad) == 0 for x in xs)


def test_k2_refuses_what_it_does_not_take(card):
    a, p, n, valid = _k2_inputs(card, 16, 3, 8, seed=1)
    with pytest.raises(TypeError):
        info_nce_fwd(a.double(), p.double(), n.double(), valid, 0.07)
    wide = torch.randn((16, 16), device=card)
    with pytest.raises(ValueError):
        info_nce_fwd(wide[:, ::2], p, n, valid, 0.07)          # non-contiguous
    with pytest.raises(ValueError):
        info_nce_fwd(a, p.cpu(), n, valid, 0.07)               # device mismatch
    with pytest.raises(ValueError):
        info_nce_bwd(a, p, n, valid, 0.07, torch.ones((15,), device=card))
    with pytest.raises(ValueError):
        info_nce_fwd(torch.randn((16, 600), device=card), torch.randn((16, 600), device=card),
                     torch.randn((16, 3, 600), device=card), valid, 0.07)   # E > 128
