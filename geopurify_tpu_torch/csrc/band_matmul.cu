// Banded-window matmul for Hopper (sm_90a) — the 19x smoothing core.
//
// Replaces the TPU kernel geopurify_tpu/ops/pallas_band.py::banded_window_matmul
// (body _kernel :43-75, pallas_call :115). It computes the same function:
//
//   out[r, :] = sum_{j < band} S[r, j] * F[starts[r / row_tile] + j, :]
//
// with S and F in bf16 and the sum in f32; rows r >= R are neither read nor
// written. F is [M, 32] (the wrapper pads C <= 32 to 32 columns), and a
// window row past M - 1 reads row M - 1 (the plain version's clamp; the
// banded operator keeps start + band <= M anyway).
//
// What bounds it on the card: bytes. At the Stage-2 shape (M = 65536,
// band = 12288, C = 32) S is 65536 x 12288 x 2 B = 1.61 GB and is read once
// per round; the F windows add 32 x 12288 x 32 x 2 B = 25 MB. At 3.35 TB/s
// that is ~0.49 ms a round. The FLOPs (2 x 65536 x 12288 x 32 = 51.5 G) are
// ~0.05 ms at the bf16 tensor-core rate.
//
// Design: every S element is read exactly once, so one block owns a slab of
// BM = 128 rows and ALL 32 output columns (a block per column slab would
// re-read S). The TPU kernel's sequential grid with a prefetched window DMA
// becomes an in-block loop over the band in BK = 64 chunks: the S chunk
// [128 x 64] and the F-window chunk [64 x 32] are staged in shared memory
// with cp.async, double-buffered so the next chunk's loads overlap this
// chunk's WMMA bf16 mma (m16n16k16, f32 accumulate). Eight warps each own
// 16 rows x 32 columns (two accumulator fragments). The window start is
// read by the block itself from `starts` (the TPU's scalar prefetch).
// Blocks of one row tile share their F window, which then comes from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;           // rows per block (8 warps x 16)
constexpr int BK = 64;            // band chunk
constexpr int CN = 32;            // output / F columns
constexpr int LDS = BK + 8;       // padded smem leading dims (bank spread,
constexpr int LDF = CN + 8;       // rows stay 32-byte aligned for wmma)
constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
band_matmul_kernel(const __nv_bfloat16* __restrict__ S,
                   const int* __restrict__ starts,
                   const __nv_bfloat16* __restrict__ F,
                   float* __restrict__ out,
                   int R, int M, int band, int row_tile) {
  __shared__ __align__(128) __nv_bfloat16 sS[2][BM * LDS];
  __shared__ __align__(128) __nv_bfloat16 sF[2][BK * LDF];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const long row0 = static_cast<long>(blockIdx.x) * BM;
  const int start = starts[row0 / row_tile];
  const int nk = (band + BK - 1) / BK;

  auto load_chunk = [&](int c, int buf) {
    const int k0 = c * BK;
    // S chunk: BM rows x BK cols = BM * 8 vectors of 8 bf16
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8);
      const int v = i % (BK / 8);
      const long grow = row0 + r;
      const int k = k0 + v * 8;
      const bool ok = grow < R && k < band;
      const __nv_bfloat16* src = ok ? S + grow * band + k : S;
      cp_async16(&sS[buf][r * LDS + v * 8], src, ok);
    }
    // F window chunk: BK rows x 32 cols = BK * 4 vectors
    for (int i = tid; i < BK * (CN / 8); i += THREADS) {
      const int r = i / (CN / 8);
      const int v = i % (CN / 8);
      const int k = k0 + r;
      const bool ok = k < band;
      const long frow = min(start + k, M - 1);
      const __nv_bfloat16* src = ok ? F + frow * CN + v * 8 : F;
      cp_async16(&sF[buf][r * LDF + v * 8], src, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  load_chunk(0, 0);
  for (int c = 0; c < nk; ++c) {
    const int buf = c & 1;
    if (c + 1 < nk) {
      load_chunk(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &sS[buf][(warp * 16) * LDS + kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &sF[buf][kk * LDF + j * 16], LDF);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
  // `out` has ceil(R / BM) * BM rows (the wrapper allocates them), so the
  // ragged last block stores whole fragments; the wrapper slices to R.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(out + (row0 + warp * 16) * CN + j * 16, acc[j], CN,
                            wmma::mem_row_major);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers come from
// tensor.data_ptr(), the stream from torch.cuda.current_stream().cuda_stream.
// Returns cudaGetLastError() after the launch; 0 means launched.
extern "C" int band_matmul(const void* S, const void* starts, const void* F,
                           void* out, int R, int M, int band, int row_tile,
                           void* stream) {
  if (R <= 0) return 0;
  dim3 grid((R + BM - 1) / BM);
  band_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(S), static_cast<const int*>(starts),
      static_cast<const __nv_bfloat16*>(F), static_cast<float*>(out), R, M,
      band, row_tile);
  return static_cast<int>(cudaGetLastError());
}
