// Banded-window matmul for Hopper (sm_90a) — the 19x smoothing core.
//
// Replaces the TPU kernel geopurify_tpu/ops/pallas_band.py::banded_window_matmul
// (body _kernel :43-75, pallas_call :115). It computes the same function:
//
//   out[r, :] = sum_{j < band} S[r, j] * F[starts[r / row_tile] + j, :]
//
// with S and F in bf16 and the sum in f32; rows r >= R are neither read nor
// written. F is [M, ldf] with ldf a multiple of the instantiation's column
// count CN (the wrapper pads C to it), and a window row past M - 1 reads row
// M - 1 (the plain version's clamp; the banded operator keeps
// start + band <= M anyway).
//
// What bounds it on the card: bytes at the class counts the logit-space
// path smooths. At M = 65536, band = 12288, C = 19 (padded to 32) S is
// 1.61 GB and is read once per round; the F windows add
// 32 x 12288 x 32 x 2 B = 25 MB. At 3.35 TB/s that is ~0.49 ms a round,
// against ~0.05 ms of bf16 tensor-core work. The work grows with C: at
// C = 256 it is 2 x 65536 x 12288 x 256 = 412 GFLOP, ~0.42 ms at the bf16
// peak, on a par with the bytes.
//
// Design: every S element is read once per column slab, so one block owns a
// slab of BM rows and ALL CN output columns (a block per narrower column
// slab would re-read S). CN is a template parameter, 32 / 64 / 128 / 256;
// a wider F (feature-space smoothing, C = 512) runs as column slabs of 256,
// one per blockIdx.y, and reads S once per slab. The TPU kernel's
// sequential grid with a prefetched window DMA becomes an in-block loop
// over the band in BK = 64 chunks: the S chunk [BM x 64] and the F-window
// chunk [64 x CN] are staged in shared memory with cp.async, double-buffered
// so the next chunk's loads overlap this chunk's WMMA bf16 mma (m16n16k16,
// f32 accumulate). Eight warps tile the block as WR row groups x (8 / WR)
// column groups; each warp keeps FR x FC accumulator fragments in registers.
// Above 32 columns each warp owns two or more 16-row fragment rows (warp
// tiles of 32 x 32, 64 x 32 and 32 x 64 at 64, 128 and 256 columns), so
// each B fragment loaded from shared memory feeds two or more mma. The
// tiling keeps at most 64
// accumulators a thread and at most 86 KB of shared memory a block (dynamic
// above 48 KB), so two blocks reside on an SM at every CN. The window start
// is read by the block itself from `starts` (the TPU's scalar prefetch).
// Blocks of one row tile share their F window, which then comes from L2: at
// wide C that re-read (band x CN x 2 B a block, CN / BM times the S bytes)
// and not HBM is what holds the kernel back.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BK = 64;            // band chunk
constexpr int LDS = BK + 8;       // padded smem leading dim of the S chunk
constexpr int THREADS = 256;      // eight warps

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

// CN output columns a block, BM rows a block, WR warp rows (8 / WR warp
// columns). Shared memory: two S chunks [BM x LDS] then two F chunks
// [BK x (CN + 8)], bf16; rows stay 32-byte aligned for wmma.
template <int CN, int BM, int WR>
struct Tile {
  static constexpr int WC = 8 / WR;
  static constexpr int FR = BM / (16 * WR);   // row fragments a warp
  static constexpr int FC = CN / (16 * WC);   // column fragments a warp
  static constexpr int LDF = CN + 8;
  static constexpr int S_ELEMS = BM * LDS;
  static constexpr int F_ELEMS = BK * LDF;
  static constexpr int SMEM_BYTES = 2 * (S_ELEMS + F_ELEMS) * 2;
  static_assert(FR >= 1 && FC >= 1 && FR * 16 * WR == BM && FC * 16 * WC == CN,
                "tile does not divide into 16 x 16 fragments");
  static_assert(FR * FC <= 8, "at most 64 accumulators a thread");
};

template <int CN, int BM, int WR>
__global__ void __launch_bounds__(THREADS, 2)
band_matmul_kernel(const __nv_bfloat16* __restrict__ S,
                   const int* __restrict__ starts,
                   const __nv_bfloat16* __restrict__ F,
                   float* __restrict__ out,
                   int R, int M, int band, int row_tile, int ldf) {
  using T = Tile<CN, BM, WR>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sS = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [2][S_ELEMS]
  __nv_bfloat16* sF = sS + 2 * T::S_ELEMS;                           // [2][F_ELEMS]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / T::WC;
  const int wc = warp % T::WC;
  const long row0 = static_cast<long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * CN;       // this block's column slab of F / out
  const int start = starts[row0 / row_tile];
  const int nk = (band + BK - 1) / BK;

  auto load_chunk = [&](int c, int buf) {
    const int k0 = c * BK;
    __nv_bfloat16* s_dst = sS + buf * T::S_ELEMS;
    __nv_bfloat16* f_dst = sF + buf * T::F_ELEMS;
    // S chunk: BM rows x BK cols = BM * 8 vectors of 8 bf16
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8);
      const int v = i % (BK / 8);
      const long grow = row0 + r;
      const int k = k0 + v * 8;
      const bool ok = grow < R && k < band;
      const __nv_bfloat16* src = ok ? S + grow * band + k : S;
      cp_async16(&s_dst[r * LDS + v * 8], src, ok);
    }
    // F window chunk: BK rows x CN cols = BK * CN / 8 vectors
    for (int i = tid; i < BK * (CN / 8); i += THREADS) {
      const int r = i / (CN / 8);
      const int v = i % (CN / 8);
      const int k = k0 + r;
      const bool ok = k < band;
      const long frow = min(start + k, M - 1);
      const __nv_bfloat16* src = ok ? F + frow * ldf + col0 + v * 8 : F;
      cp_async16(&f_dst[r * T::LDF + v * 8], src, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FR][T::FC];
#pragma unroll
  for (int i = 0; i < T::FR; ++i)
#pragma unroll
    for (int j = 0; j < T::FC; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

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
    const __nv_bfloat16* s_cur = sS + buf * T::S_ELEMS;
    const __nv_bfloat16* f_cur = sF + buf * T::F_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[T::FR];
#pragma unroll
      for (int i = 0; i < T::FR; ++i)
        wmma::load_matrix_sync(a[i], &s_cur[((wr * T::FR + i) * 16) * LDS + kk], LDS);
#pragma unroll
      for (int j = 0; j < T::FC; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &f_cur[kk * T::LDF + (wc * T::FC + j) * 16], T::LDF);
#pragma unroll
        for (int i = 0; i < T::FR; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
  // `out` has ldf columns and rows up to a multiple of 128 (the wrapper
  // allocates them; every BM divides 128), so the ragged last block stores
  // whole fragments; the wrapper slices to [R, C].
#pragma unroll
  for (int i = 0; i < T::FR; ++i)
#pragma unroll
    for (int j = 0; j < T::FC; ++j) {
      const long r = row0 + (wr * T::FR + i) * 16;
      const int col = col0 + (wc * T::FC + j) * 16;
      wmma::store_matrix_sync(out + r * ldf + col, acc[i][j], ldf, wmma::mem_row_major);
    }
}

template <int CN, int BM, int WR>
int launch(const void* S, const void* starts, const void* F, void* out, int R,
           int M, int band, int row_tile, int ldf, cudaStream_t stream) {
  using T = Tile<CN, BM, WR>;
  auto kernel = band_matmul_kernel<CN, BM, WR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + BM - 1) / BM, ldf / CN);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(S), static_cast<const int*>(starts),
      static_cast<const __nv_bfloat16*>(F), static_cast<float*>(out), R, M, band,
      row_tile, ldf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers come from
// tensor.data_ptr(), the stream from torch.cuda.current_stream().cuda_stream.
// `cn` picks the instantiation (32, 64, 128 or 256 columns a block); `ldf`,
// the row stride of F and out, is a multiple of it, and ldf / cn column
// slabs run side by side. Returns cudaGetLastError() after the launch; 0
// means launched, cudaErrorInvalidValue an unknown `cn`.
extern "C" int band_matmul(const void* S, const void* starts, const void* F,
                           void* out, int R, int M, int band, int row_tile,
                           int ldf, int cn, void* stream) {
  if (R <= 0) return 0;
  if (cn <= 0 || ldf % cn) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cn) {
    case 32:  return launch<32, 128, 8>(S, starts, F, out, R, M, band, row_tile, ldf, st);
    case 64:  return launch<64, 128, 4>(S, starts, F, out, R, M, band, row_tile, ldf, st);
    case 128: return launch<128, 128, 2>(S, starts, F, out, R, M, band, row_tile, ldf, st);
    case 256: return launch<256, 64, 2>(S, starts, F, out, R, M, band, row_tile, ldf, st);
    default:  return static_cast<int>(cudaErrorInvalidValue);
  }
}
