"""K2: the fused InfoNCE loss — Stage-1's contrastive loss, forward and backward.

Port of the TPU kernels of geopurify_tpu/ops/pallas_infonce.py (forward
``_fwd_kernel`` :33-58, backward ``_bwd_kernel`` :61-110) and of their
custom VJP ``info_nce_loss_fused`` (:161-193). Per anchor ``i``:

    per[i] = (logsumexp(lp, ln_1 .. ln_NEG) - lp) * valid[i]
    lp = a^.p^ / T,  ln_k = a^.n^_k / T,  x^ = x * rsqrt(|x|^2 + 1e-12)

and the loss is ``sum(per) / max(sum(valid), 1)``. On a CUDA tensor each
wrapper launches its hand-written Hopper kernel in ``csrc/infonce.cu``
(bytes-bound: it streams ``n`` once forward, twice backward; see the source
note) or raises; on a CPU tensor it runs the plain version beside it.
"""

from __future__ import annotations

import ctypes

import torch

from geopurify_tpu_torch.utils.profiling import counts_launches, hand_kernel

_EPS = 1e-12
_MAX_E = 128              # the kernel keeps at most 4 floats a lane


def _norm_rows(x):
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + _EPS)


def _work_dtype(x):
    # f32 (the kernel's type), or f64 for gradcheck
    return torch.promote_types(x.dtype, torch.float32)


# geopurify_tpu/ops/pallas_infonce.py:33
def per_anchor_loss_ref(a, p, n, valid, temperature: float) -> torch.Tensor:
    """Plain version of the forward kernel: per-anchor loss [A]."""
    dt = _work_dtype(a)
    an, pn, nn_ = (_norm_rows(x.to(dt)) for x in (a, p, n))
    lp = (an * pn).sum(-1) / temperature
    ln = torch.einsum("ae,ane->an", an, nn_) / temperature
    logits = torch.cat([lp[:, None], ln], 1)
    return (torch.logsumexp(logits, 1) - lp) * valid.to(dt)


# geopurify_tpu/ops/pallas_infonce.py:61
def per_anchor_grads_ref(a, p, n, valid, temperature: float, g):
    """Plain version of the backward kernel: (da, dp, dn) of
    ``sum_i g[i] * per[i]``, through the L2 normalisation."""
    dt = _work_dtype(a)
    a, p, n = a.to(dt), p.to(dt), n.to(dt)
    inv_a = torch.rsqrt((a * a).sum(-1, keepdim=True) + _EPS)
    inv_p = torch.rsqrt((p * p).sum(-1, keepdim=True) + _EPS)
    inv_n = torch.rsqrt((n * n).sum(-1, keepdim=True) + _EPS)
    an, pn, nn_ = a * inv_a, p * inv_p, n * inv_n
    inv_t = 1.0 / temperature
    lp = (an * pn).sum(-1) * inv_t
    ln = torch.einsum("ae,ane->an", an, nn_) * inv_t
    lse = torch.logsumexp(torch.cat([lp[:, None], ln], 1), 1)
    gi = g.to(dt) * valid.to(dt)
    coef_p = (torch.exp(lp - lse) - 1.0) * gi * inv_t                  # [A]
    ck = torch.exp(ln - lse[:, None]) * (gi * inv_t)[:, None]         # [A, NEG]

    def unnorm(gv, xhat, inv):
        return (gv - (gv * xhat).sum(-1, keepdim=True) * xhat) * inv

    dn = unnorm(ck[..., None] * an[:, None], nn_, inv_n)
    g_a = coef_p[:, None] * pn + (ck[..., None] * nn_).sum(1)
    return (unnorm(g_a, an, inv_a), unnorm(coef_p[:, None] * an, pn, inv_p), dn)


def _check(a, p, n, valid, extra=()):
    A, E = a.shape
    if n.dim() != 3 or n.shape[0] != A or n.shape[2] != E or p.shape != (A, E):
        raise ValueError(f"shapes a {tuple(a.shape)}, p {tuple(p.shape)}, "
                         f"n {tuple(n.shape)} do not fit [A, E], [A, E], [A, NEG, E]")
    if valid.shape != (A,):
        raise ValueError(f"valid must be [{A}], got {tuple(valid.shape)}")
    for name, x in (("a", a), ("p", p), ("n", n)) + tuple(extra):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not all(x.is_cuda and x.device == a.device
               for x in (p, n, valid) + tuple(x for _, x in extra)):
        raise ValueError("a, p, n, valid (and g) must lie on one CUDA device")
    if not 1 <= E <= _MAX_E:
        raise ValueError(f"E={E} outside the kernel's 1..{_MAX_E}")
    vec = E == 128 and all(x.data_ptr() % 16 == 0 for x in (a, p, n))
    return A, n.shape[1], E, int(vec)


def info_nce_work(A: int, NEG: int, E: int, backward: bool):
    """(operations, bytes) of one kernel call. Each input read once and each
    output written once: a, p, n f32 and valid bool in; the per-anchor loss
    out (forward), or g in and da, dp, dn out (backward). Operations: ~4 E
    flops a row for its norm and its dot with the anchor (NEG + 2 rows),
    ~3x that backward."""
    emb = 4 * (2 * A * E + A * NEG * E)
    bytes_ = emb + A + (4 * A + emb if backward else 4 * A)
    return 4.0 * E * (NEG + 2) * A * (3 if backward else 1), bytes_


@counts_launches
def info_nce_fwd(a, p, n, valid, temperature: float) -> torch.Tensor:
    """Per-anchor loss [A] f32 (the forward kernel). ``a``, ``p`` [A, E],
    ``n`` [A, NEG, E] f32 contiguous, ``valid`` [A] bool. Under
    ``utils.profiling.compiled_costs`` it counts ``info_nce_work`` on
    either route."""
    with hand_kernel(*info_nce_work(a.shape[0], n.shape[1], a.shape[-1], False)):
        if not a.is_cuda:
            return per_anchor_loss_ref(a, p, n, valid, temperature)
        return _fwd_launch(a, p, n, valid, temperature)


def _fwd_launch(a, p, n, valid, temperature: float) -> torch.Tensor:
    A, NEG, E, vec = _check(a, p, n, valid)
    v = valid.to(torch.float32).contiguous()
    per = torch.empty((A,), dtype=torch.float32, device=a.device)
    err = _lib().infonce_fwd(
        a.data_ptr(), p.data_ptr(), n.data_ptr(), v.data_ptr(), per.data_ptr(),
        A, NEG, E, 1.0 / temperature, vec,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"infonce_fwd launch failed: CUDA error {err}")
    info_nce_fwd.launches += 1
    return per


@counts_launches
def info_nce_bwd(a, p, n, valid, temperature: float, g):
    """(da, dp, dn) f32 (the backward kernel) of ``sum_i g[i] * per[i]``;
    ``g`` [A] f32."""
    with hand_kernel(*info_nce_work(a.shape[0], n.shape[1], a.shape[-1], True)):
        if not a.is_cuda:
            return per_anchor_grads_ref(a, p, n, valid, temperature, g)
        return _bwd_launch(a, p, n, valid, temperature, g)


def _bwd_launch(a, p, n, valid, temperature: float, g):
    A, NEG, E, vec = _check(a, p, n, valid, (("g", g),))
    if g.shape != (A,):
        raise ValueError(f"g must be [{A}], got {tuple(g.shape)}")
    v = valid.to(torch.float32).contiguous()
    da = torch.empty_like(a)
    dp = torch.empty_like(p)
    dn = torch.empty_like(n)
    err = _lib().infonce_bwd(
        a.data_ptr(), p.data_ptr(), n.data_ptr(), v.data_ptr(), g.data_ptr(),
        da.data_ptr(), dp.data_ptr(), dn.data_ptr(), A, NEG, E, 1.0 / temperature,
        vec, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"infonce_bwd launch failed: CUDA error {err}")
    info_nce_bwd.launches += 1
    return da, dp, dn


class _InfoNCEFused(torch.autograd.Function):
    # geopurify_tpu/ops/pallas_infonce.py:179 (_fused_fwd) and :184 (_fused_bwd)
    @staticmethod
    def forward(ctx, a, p, n, valid, temperature):
        per = info_nce_fwd(a, p, n, valid, temperature)
        denom = torch.clamp(valid.to(per.dtype).sum(), min=1.0)
        ctx.save_for_backward(a, p, n, valid, denom)
        ctx.temperature = temperature
        return per.sum() / denom

    @staticmethod
    def backward(ctx, g):
        a, p, n, valid, denom = ctx.saved_tensors
        g_per = (g / denom).to(a.dtype).expand(a.shape[0]).contiguous()
        da, dp, dn = info_nce_bwd(a, p, n, valid, ctx.temperature, g_per)
        return da.to(a.dtype), dp.to(p.dtype), dn.to(n.dtype), None, None


# geopurify_tpu/ops/pallas_infonce.py:161
def info_nce_loss_fused(anchor_embed, positive_embed, negative_embed,
                        anchor_valid, temperature: float = 0.07) -> torch.Tensor:
    """Masked-mean InfoNCE (label 0 = positive) through K2, differentiable in
    the three embeddings."""
    return _InfoNCEFused.apply(anchor_embed, positive_embed, negative_embed,
                               anchor_valid, temperature)


def _lib():
    from geopurify_tpu_torch.utils.cuda_build import load

    lib = load("infonce")
    if not getattr(lib, "_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.infonce_fwd.argtypes = [ptr] * 5 + [i32] * 3 + [f32, i32, ptr]
        lib.infonce_bwd.argtypes = [ptr] * 8 + [i32] * 3 + [f32, i32, ptr]
        lib.infonce_fwd.restype = lib.infonce_bwd.restype = ctypes.c_int
        lib._typed = True
    return lib
