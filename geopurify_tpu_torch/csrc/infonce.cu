// Fused InfoNCE for Hopper (sm_90a) — the Stage-1 contrastive loss, K2.
//
// Replaces the TPU kernels of geopurify_tpu/ops/pallas_infonce.py:
//   infonce_fwd: _fwd_kernel (:33-58, pallas_call :128), per-anchor loss
//     per[i] = (logsumexp(lp, ln_1..ln_NEG) - lp) * valid[i],
//     lp = a^.p^ / T, ln_k = a^.n^_k / T, x^ = x * rsqrt(|x|^2 + 1e-12);
//   infonce_bwd: _bwd_kernel (:61-110, pallas_call :146), da, dp, dn of
//     sum_i g[i] * per[i] (g is the upstream gradient per anchor).
// All f32. a, p are [A, E]; n is [A, NEG, E]; valid and g are [A] f32.
//
// What bounds it on the card: bytes. At the Stage-1 shape (A = 4096,
// NEG = 63, E = 128) n is 132.1 MB and a, p 2.1 MB each: the forward reads
// ~136.3 MB (~41 us at 3.35 TB/s); the backward reads a, p, n and writes
// da, dp, dn, ~272.6 MB (~81 us). The arithmetic, ~0.13 GFLOP, is noise.
//
// Design: one warp per anchor, 8 warps per block; nothing crosses warps,
// so the TPU kernel's sequential grid over anchor blocks becomes a plain
// grid of independent blocks. Rows hold E <= 128 floats (the student's
// embed_dim): each lane keeps up to 4 elements of a^ and p^ in registers
// (one 16-byte load when E == 128 and the rows are 16-byte aligned, masked
// scalar loads otherwise). The negatives stream
// through registers one row per step, the next row's load issued before
// the current row is reduced: |n_k|^2 and a^.n_k come out of one pair of
// butterfly shuffles, and an online (max, sum) replaces the [A, NEG] logit
// matrix, as in the TPU kernel. The backward's pass 1 rebuilds (max, sum);
// pass 2 re-reads n to emit dn_k and accumulate the anchor gradient, a
// known 1.5x over the byte bound (keeping n in shared memory is later
// work). Dot products are reused instead of recomputed: a^.n^_k and a^.p^
// come from the forward reductions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;          // anchors per block
constexpr int NPL = 4;            // floats per lane: E <= 128
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void warp_sum2(float& u, float& v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    u += __shfl_xor_sync(0xffffffffu, u, o);
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
}

// Lane `lane` owns elements (j*32 + lane)*4 .. +3 (VEC) or j*32 + lane.
template <bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int E,
                                         int lane, float (&x)[NPL]) {
  if (VEC) {
#pragma unroll
    for (int j = 0; j < NPL / 4; ++j) {
      const int e = (j * 32 + lane) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < E) v = *reinterpret_cast<const float4*>(row + e);
      x[4 * j] = v.x; x[4 * j + 1] = v.y; x[4 * j + 2] = v.z; x[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int e = j * 32 + lane;
      x[j] = e < E ? row[e] : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ row, int E,
                                          int lane, const float (&x)[NPL]) {
  if (VEC) {
#pragma unroll
    for (int j = 0; j < NPL / 4; ++j) {
      const int e = (j * 32 + lane) * 4;
      if (e < E)
        *reinterpret_cast<float4*>(row + e) =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int e = j * 32 + lane;
      if (e < E) row[e] = x[j];
    }
  }
}

__device__ __forceinline__ float dot(const float (&x)[NPL], const float (&y)[NPL]) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) s += x[j] * y[j];
  return s;
}

// Normalised anchor and positive of one anchor, with their inverse norms
// and lp = a^.p^ / T.
template <bool VEC>
__device__ __forceinline__ void load_anchor(const float* a, const float* p, long i,
                                            int E, int lane, float (&an)[NPL],
                                            float (&pn)[NPL], float& inv_a,
                                            float& inv_p) {
  load_row<VEC>(a + i * E, E, lane, an);
  load_row<VEC>(p + i * E, E, lane, pn);
  float sa = dot(an, an), sp = dot(pn, pn);
  warp_sum2(sa, sp);
  inv_a = rsqrtf(sa + kEps);
  inv_p = rsqrtf(sp + kEps);
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    an[j] *= inv_a;
    pn[j] *= inv_p;
  }
}

// Online (max, sum) over the negatives of anchor i, starting from the
// positive's logit lp (exp(lp - lp) = 1).
template <bool VEC>
__device__ __forceinline__ void softmax_stats(const float* __restrict__ nrow0, int NEG,
                                              int E, int lane, const float (&an)[NPL],
                                              float lp, float inv_t, float& m,
                                              float& z) {
  m = lp;
  z = 1.f;
  float cur[NPL], nxt[NPL];
  if (NEG > 0) load_row<VEC>(nrow0, E, lane, cur);
  for (int k = 0; k < NEG; ++k) {
    if (k + 1 < NEG) load_row<VEC>(nrow0 + static_cast<long>(k + 1) * E, E, lane, nxt);
    float snn = dot(cur, cur), san = dot(an, cur);
    warp_sum2(snn, san);
    const float d = san * rsqrtf(snn + kEps) * inv_t;
    const float m_new = fmaxf(m, d);
    z = z * expf(m - m_new) + expf(d - m_new);
    m = m_new;
#pragma unroll
    for (int j = 0; j < NPL; ++j) cur[j] = nxt[j];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
infonce_fwd_kernel(const float* __restrict__ a, const float* __restrict__ p,
                   const float* __restrict__ n, const float* __restrict__ valid,
                   float* __restrict__ per, int A, int NEG, int E, float inv_t) {
  const int lane = threadIdx.x & 31;
  const long i = static_cast<long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (i >= A) return;
  float an[NPL], pn[NPL], inv_a, inv_p;
  load_anchor<VEC>(a, p, i, E, lane, an, pn, inv_a, inv_p);
  const float lp = warp_sum(dot(an, pn)) * inv_t;
  float m, z;
  softmax_stats<VEC>(n + i * NEG * E, NEG, E, lane, an, lp, inv_t, m, z);
  if (lane == 0) per[i] = (m + logf(z) - lp) * valid[i];
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
infonce_bwd_kernel(const float* __restrict__ a, const float* __restrict__ p,
                   const float* __restrict__ n, const float* __restrict__ valid,
                   const float* __restrict__ g, float* __restrict__ da,
                   float* __restrict__ dp, float* __restrict__ dn, int A, int NEG,
                   int E, float inv_t) {
  const int lane = threadIdx.x & 31;
  const long i = static_cast<long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (i >= A) return;
  float an[NPL], pn[NPL], inv_a, inv_p;
  load_anchor<VEC>(a, p, i, E, lane, an, pn, inv_a, inv_p);
  const float ap = warp_sum(dot(an, pn));
  const float lp = ap * inv_t;
  const float* nrow0 = n + i * NEG * E;
  float* dnrow0 = dn + i * NEG * E;
  float m, z;
  softmax_stats<VEC>(nrow0, NEG, E, lane, an, lp, inv_t, m, z);   // pass 1

  const float gi = g[i] * valid[i];
  const float coef_p = (expf(lp - m) / z - 1.f) * gi * inv_t;
  float ga[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) ga[j] = coef_p * pn[j];

  // pass 2: dn_k = (c_k a^ - c_k (a^.n^_k) n^_k) / |n_k|, g_a += c_k n^_k
  float cur[NPL], nxt[NPL], out[NPL];
  if (NEG > 0) load_row<VEC>(nrow0, E, lane, cur);
  for (int k = 0; k < NEG; ++k) {
    if (k + 1 < NEG) load_row<VEC>(nrow0 + static_cast<long>(k + 1) * E, E, lane, nxt);
    float snn = dot(cur, cur), san = dot(an, cur);
    warp_sum2(snn, san);
    const float inv_k = rsqrtf(snn + kEps);
    const float an_k = san * inv_k;                 // a^.n^_k
    const float ck = expf(an_k * inv_t - m) / z * gi * inv_t;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const float nk = cur[j] * inv_k;
      out[j] = (ck * an[j] - ck * an_k * nk) * inv_k;
      ga[j] += ck * nk;
      cur[j] = nxt[j];
    }
    store_row<VEC>(dnrow0 + static_cast<long>(k) * E, E, lane, out);
  }
  // da = (g_a - (g_a.a^) a^) / |a|; dp = (coef_p a^ - coef_p (a^.p^) p^) / |p|
  const float gaa = warp_sum(dot(ga, an));
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    out[j] = (ga[j] - gaa * an[j]) * inv_a;
    ga[j] = (coef_p * an[j] - coef_p * ap * pn[j]) * inv_p;
  }
  store_row<VEC>(da + i * E, E, lane, out);
  store_row<VEC>(dp + i * E, E, lane, ga);
}

template <bool VEC>
void launch_fwd(const float* a, const float* p, const float* n, const float* valid,
                float* per, int A, int NEG, int E, float inv_t, cudaStream_t s) {
  infonce_fwd_kernel<VEC><<<(A + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      a, p, n, valid, per, A, NEG, E, inv_t);
}

template <bool VEC>
void launch_bwd(const float* a, const float* p, const float* n, const float* valid,
                const float* g, float* da, float* dp, float* dn, int A, int NEG, int E,
                float inv_t, cudaStream_t s) {
  infonce_bwd_kernel<VEC><<<(A + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      a, p, n, valid, g, da, dp, dn, A, NEG, E, inv_t);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers come from
// tensor.data_ptr(), the stream from torch.cuda.current_stream().cuda_stream.
// `vec` selects 16-byte loads (the wrapper checks E == 128 and 16-byte
// alignment). Each returns cudaGetLastError() after the launch; 0 means
// launched.
extern "C" int infonce_fwd(const void* a, const void* p, const void* n,
                           const void* valid, void* per, int A, int NEG, int E,
                           float inv_t, int vec, void* stream) {
  if (A <= 0) return 0;
  if (E < 1 || E > NPL * 32) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fp = static_cast<const float*>(p);
  auto fn = static_cast<const float*>(n);
  auto fv = static_cast<const float*>(valid);
  auto fo = static_cast<float*>(per);
  if (vec) launch_fwd<true>(fa, fp, fn, fv, fo, A, NEG, E, inv_t, s);
  else launch_fwd<false>(fa, fp, fn, fv, fo, A, NEG, E, inv_t, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int infonce_bwd(const void* a, const void* p, const void* n,
                           const void* valid, const void* g, void* da, void* dp,
                           void* dn, int A, int NEG, int E, float inv_t, int vec,
                           void* stream) {
  if (A <= 0) return 0;
  if (E < 1 || E > NPL * 32) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fp = static_cast<const float*>(p);
  auto fn = static_cast<const float*>(n);
  auto fv = static_cast<const float*>(valid);
  auto fg = static_cast<const float*>(g);
  auto oa = static_cast<float*>(da);
  auto op = static_cast<float*>(dp);
  auto on = static_cast<float*>(dn);
  if (vec) launch_bwd<true>(fa, fp, fn, fv, fg, oa, op, on, A, NEG, E, inv_t, s);
  else launch_bwd<false>(fa, fp, fn, fv, fg, oa, op, on, A, NEG, E, inv_t, s);
  return static_cast<int>(cudaGetLastError());
}
