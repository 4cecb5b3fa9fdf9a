// Banded-window matmul for Hopper (sm_90a) — the 19x smoothing core, K1.
//
// Replaces the TPU kernel geopurify_tpu/ops/pallas_band.py::banded_window_matmul
// (body _kernel :43-75, pallas_call :115). It computes the same function:
//
//   out[r, :] = sum_{j < band} S[r, j] * F[starts[r / row_tile] + j, :]
//
// with S and F in bf16 and the sum in f32; rows r >= R are neither read nor
// written, and a window row past M - 1 reads row M - 1 (the plain version's
// clamp; the banded operator keeps start + band <= M anyway).
//
// What bounds it on the card, at the preset-scale shape (M = R = 2^18,
// band 6144): S is 3.22 GB and has to come from HBM once, ~0.96 ms at
// 3.35 TB/s. The tensor-core work is 2 R band C: 0.13 TFLOP at C = 40,
// 0.64 at C = 200 (0.65 ms at the 989 TFLOP/s bf16 peak), 1.65 at C = 512
// (1.67 ms). So bytes bound it up to C ~ 256 and operations at C = 512.
//
// Two kernels, chosen by ops/band.py::_plan:
//
// C <= 32 — WMMA (mma.sync m16n16k16, f32 accumulate), one block of 256
// threads per 128 rows and all 32 columns, so S is read once; S chunks
// [128 x 64] and F-window chunks [64 x 32] are staged in shared memory with
// cp.async, double-buffered. It reaches 73-76% of its byte bound and beats
// torch.bmm over gathered windows, so it stays as it was.
//
// C > 32 — wgmma fed by TMA through an mbarrier ring, warp-specialised:
// - A block owns 128 output rows and BN columns. Warpgroups 0 and 1 each
//   keep a 64 x BN f32 accumulator in registers (BN / 2 a thread) and issue
//   wgmma.m64nBNk16; the first warp of warpgroup 2 is the producer, one
//   lane of which keeps TMA loads in flight. setmaxnreg moves registers
//   from the producer (72) to the consumers (216): 168 a thread at launch.
// - The band runs in chunks of 64. A stage holds the S chunk [128 x 64]
//   (A, K-major, 128-byte swizzle) and the F-window chunk [64 x BN] read
//   straight from F (B, MN-major: F's rows run along C), 3 to 8 stages as
//   shared memory allows. TMA's zero fill covers the ragged band (S's
//   columns past `band`), the ragged rows and the columns past C.
// - BN and the swizzle go together. An MN-major swizzle atom is 8 rows of
//   128 bytes at the 128-byte swizzle (64 columns), 64 at 64 bytes, 32 at
//   32 bytes, one TMA box of 64 rows a chunk column. The narrow atoms fit
//   BN tighter but cost a TMA request per 32 or 64 bytes, two to four
//   times as many as the 128-byte rows, and run slower. So the chunk is
//   always made of 64-column atoms, ceil(BN / 64) boxes, and the wgmma's
//   N reads only the first BN columns of the last one: BN may be any
//   multiple of 8, the wgmma N step (ops/band.py::WGMMA_COLS). The
//   presets' 40, 80, 160 and 200 classes run unpadded, not as the 64, 128,
//   256 and 256 columns of a power-of-two tile; columns past C come from
//   TMA's zero fill, not HBM.
// - The clamp: TMA fills rows past M - 1 with zeros, not with row M - 1.
//   A chunk whose band rows run past M - 1 (only outside the operator's
//   contract) is written instead by the producer warp, row by row at
//   min(row, M - 1) and in TMA's swizzled layout, then fenced for the
//   async proxy; only its S part comes by TMA.
// - F-window traffic. The WMMA design at 256 columns had 64-row blocks,
//   each streaming band x 256 x 2 B of window from L2: 12.9 GB a call at
//   C = 200, 4x the S bytes. 128-row blocks at BN = 200 halve the blocks
//   and cut the padding: 5.0 GB. Where two blocks share a window
//   (row_tile % 256 == 0: 2048 on every main path) they run as a cluster of
//   two, and each F chunk comes from L2 once for both, each block loading
//   half of its atom columns with a multicast TMA: 2.5 GB, 0.78x the S
//   bytes (0.16x at C = 40, 0.63x at C = 160). (Clusters of four, a
//   quarter each, ran slower on the H100.) Each block's consumers
//   release a stage in both blocks (the peer's multicast writes into it),
//   and a producer stays until the consumers of both have released every
//   stage, so no block exits while its peer can still arrive on its
//   barriers. A block of a cluster whose rows lie past R loads zeros,
//   takes part in every shared barrier and stores nothing.
// - S traffic: once from HBM. C > 256 (feature space, 512) runs as slabs of
//   equal width; the slabs of one cluster's rows are adjacent in the grid,
//   so the second slab finds S in L2.
// - Bytes in flight: a consumer frees a stage as soon as its products are
//   done when the next chunk has not arrived yet (the producer refills it
//   meanwhile), not only after the next chunk's products are issued.
// - The grid is persistent, one block an SM: a block walks over its work
//   units (a row block and a slab), the producer loading the next unit's
//   chunks while the consumers store the last one, so a block's start-up
//   (barriers, cluster sync, the first loads' latency) is paid once.
// - The accumulators go straight from registers to `out` (float2 stores).
//
// What bounds the redesign, measured on an H100 SXM at 700 W by
// scripts/k1_ablate.py (the kernel rebuilt without its products, its F
// loads or its S loads): up to C = 256 the products cost nothing, and the
// time is the S stream from HBM through L2 plus the F-window reads from L2;
// at C = 512 the products and the doubled S and F reads weigh alike. It
// runs level with torch.bmm over pre-gathered windows, which moves the
// same bytes.

#include <cuda.h>          // CUtensorMap and its enums (types only, no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

using namespace nvcuda;

namespace {

// ===========================================================================
// C <= 32: WMMA
// ===========================================================================

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

// ===========================================================================
// C > 32: wgmma + TMA
// ===========================================================================

namespace wg {

constexpr int BM = 128;           // rows a block: two consumer warpgroups of 64
constexpr int THREADS = 384;      // warpgroups 0, 1 consume, 2 produces
constexpr int SMEM_MAX = 227 * 1024;
constexpr long long WATCHDOG_NS = 4000000000LL;   // a wait this long is a fault

constexpr int AW = 64;            // columns of an F-chunk swizzle atom (128 bytes)
constexpr int ATOM_BYTES = BK * AW * 2;   // one atom column of a chunk, all 64 rows

template <int BN>
struct Cfg {
  static constexpr int ATOMS = (BN + AW - 1) / AW;   // atom columns of a chunk
  static constexpr int A_BYTES = BM * BK * 2;     // S chunk [128 x 64], K-major
  static constexpr int B_BYTES = ATOMS * ATOM_BYTES;   // F chunk [64 x BN], MN-major
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int FIT = (SMEM_MAX - 1024 - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(BN % 8 == 0 && BN <= 256 && STAGES >= 3, "wgmma tile");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Whether the phase of parity `parity` has completed (a bounded wait).
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` to complete. A wait of seconds
// means a fault in the pipeline: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (uint32_t n = 1;; ++n) {
    if (mbar_try(bar, parity)) return;
    if ((n & 4095) == 0) {
      const long long t = globaltimer();
      if (t0 == 0) t0 = t;
      else if (t - t0 > WATCHDOG_NS) __trap();
    }
  }
}

// One consumer warpgroup is done with a stage: arrive on its empty barrier
// in every block of the cluster (each block's producer may write into it).
__device__ __forceinline__ void release(uint32_t bar, int cluster) {
  if (cluster == 1) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
    return;
  }
  for (uint32_t rank = 0; rank < static_cast<uint32_t>(cluster); ++rank)
    asm volatile(
        "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
        ::"r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// 2-D TMA load of the box at (x, y) (x the inner coordinate) into shared
// memory at `dst`, completing its bytes on the barrier at `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// The same, written at `dst` and signalled at `bar` in every block of the
// cluster whose bit is set in `mask`.
__device__ __forceinline__ void tma_load_all(uint32_t dst, const CUtensorMap* map,
                                             uint32_t bar, int x, int y, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(x),
      "r"(y)
      : "memory");
}

// wgmma matrix descriptors (start address, leading and stride byte offsets
// in 16-byte units, swizzle). A, the S chunk: K-major, 128-byte rows and
// swizzle, 8-row atoms 1024 bytes apart; a 16-wide k step adds 32 bytes.
__device__ __forceinline__ uint64_t desc_a(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// B, the F chunk: MN-major, atoms of 64 columns x 8 rows with the 128-byte
// swizzle; the leading byte offset steps to the next atom column (64 rows
// on), the stride byte offset to the next 8 rows. A 16-row k step adds
// 16 * 128 bytes.
__device__ __forceinline__ uint64_t desc_b(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(ATOM_BYTES >> 4) << 16) |
         (static_cast<uint64_t>(8 * AW * 2 >> 4) << 32) | (1ull << 62);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (the registers change behind its back).
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The F chunk of window rows k .. k + 63, columns col0 .. col0 + BN - 1,
// written by the 32 lanes of the producer warp with the layout TMA gives
// it, each row read at min(row, M - 1): the clamp, which TMA (zeros past
// the last row) cannot do. Columns past the F's `cf` are zeros.
template <int BN>
__device__ void fill_clamped(uint32_t b, const __nv_bfloat16* __restrict__ F, int cf,
                             int M, int k, int col0, int lane) {
  constexpr int VEC = BN / 8;                             // 16-byte vectors a row
  for (int v = lane; v < BK * VEC; v += 32) {
    const int kr = v / VEC, n = (v % VEC) * 8;
    const long row = min(k + kr, M - 1);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (col0 + n < cf) val = *reinterpret_cast<const uint4*>(F + row * cf + col0 + n);
    uint32_t addr = b + (n / AW) * ATOM_BYTES + kr * (AW * 2) + (n % AW) * 2;
    addr ^= ((addr >> 7) & 7) << 4;                          // the 128-byte swizzle
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(val.x),
                 "r"(val.y), "r"(val.z), "r"(val.w) : "memory");
  }
  // generic-proxy writes, read next by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncwarp();
}

// The `cluster` neighbouring blocks (rank blockIdx.x % cluster) of a
// cluster take the row blocks of one row group each; the slabs of a group
// are consecutive units, so they run side by side.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
band_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_s,
                         const __grid_constant__ CUtensorMap map_f,
                         const __nv_bfloat16* __restrict__ F,
                         const int* __restrict__ starts, float* __restrict__ out,
                         int R, int M, int cf, int band, int row_tile, int ldf, int slabs,
                         int cluster, int units) {
  using G = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sA = base;                               // [STAGES][128 x 64]
  const uint32_t sB = sA + G::STAGES * G::A_BYTES;        // [STAGES][64 x BN]
  const uint32_t full = sB + G::STAGES * G::B_BYTES;      // [STAGES] mbarriers
  const uint32_t empty = full + G::STAGES * 8;            // [STAGES]

  // work unit u: row group u / slabs (its `cluster` blocks, all in one
  // row tile), slab u % slabs. The grid is persistent: a cluster (or lone
  // block) takes units first, first + step, ..., and its producer runs on
  // into the next unit while the consumers store the last one.
  const int rank = blockIdx.x % cluster;
  const int first = blockIdx.x / cluster;
  const int step = gridDim.x / cluster;
  const int nk = (band + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (cluster > 1) cluster_sync();   // the peers' barriers exist before any multicast

  if (tid >= 256) {
    // ---- producer warpgroup: its first warp keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n");
    if (tid < 288) {
      const int lane = tid - 256;
      int g = 0;                                          // chunks issued
      for (int u = first; u < units; u += step) {
        const long group = u / slabs;
        const long row0 = (group * cluster + rank) * BM;
        const int col0 = (u % slabs) * BN;
        // the blocks of a cluster lie in one row tile: the first block's
        const int start = min(starts[group * cluster * BM / row_tile], M);
        for (int c = 0; c < nk; ++c, ++g) {
          const int s = g % G::STAGES;
          if (g >= G::STAGES) mbar_wait(empty + 8 * s, ((g / G::STAGES) - 1) & 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t b = sB + s * G::B_BYTES;
          const int k = start + c * BK;
          // a chunk whose band rows run past M - 1 (outside the operator's
          // contract) is written by the warp, in every block of a cluster
          const bool clamp = k + min(BK, band - c * BK) > M;
          if (clamp) fill_clamped<BN>(b, F, cf, M, k, col0, lane);
          if (lane == 0) {
            mbar_expect_tx(bar, clamp ? G::A_BYTES : G::STAGE_BYTES);
            tma_load(sA + s * G::A_BYTES, &map_s, bar, c * BK, static_cast<int>(row0));
            if (!clamp) {
              if (cluster == 1) {
                for (int j = 0; j < G::ATOMS; ++j)
                  tma_load(b + j * ATOM_BYTES, &map_f, bar, col0 + j * AW, k);
              } else {
                // block `rank` loads atom columns rank, rank + cluster, ...
                // for all blocks of the cluster
                const uint16_t mask = static_cast<uint16_t>((1 << cluster) - 1);
                for (int j = rank; j < G::ATOMS; j += cluster)
                  tma_load_all(b + j * ATOM_BYTES, &map_f, bar, col0 + j * AW, k, mask);
              }
            }
          }
        }
      }
      // stay until every consumer of the cluster has released every stage
      for (int h = g; h < g + G::STAGES; ++h)
        if (h >= G::STAGES)
          mbar_wait(empty + 8 * (h % G::STAGES), ((h / G::STAGES) - 1) & 1);
    }
  } else {
    // ---- consumer warpgroups: rows wg * 64 .. + 63 of each block ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n");
    const int wg = tid / 128;
    const int lane = tid % 32;
    int g = 0;                                            // chunks consumed
    for (int u = first; u < units; u += step) {
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      fence_regs<BN / 2>(acc);
      for (int c = 0; c < nk; ++c, ++g) {
        const int s = g % G::STAGES;
        const uint32_t parity = (g / G::STAGES) & 1;
        // the previous chunk's stage is freed once its products are done:
        // right away if this chunk's data is late (the producer can then
        // refill it meanwhile), else after this chunk's products are issued
        // (one decision a warp: wait_group is warp-aligned)
        bool held = c > 0;
        if (held && !__shfl_sync(0xffffffffu, mbar_try(full + 8 * s, parity), 0)) {
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          if (tid % 128 == 0) release(empty + 8 * ((g - 1) % G::STAGES), cluster);
          held = false;
        }
        mbar_wait(full + 8 * s, parity);
        const uint64_t da = desc_a(sA + s * G::A_BYTES + wg * 64 * BK * 2);
        const uint64_t db = desc_b(sB + s * G::B_BYTES);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<BN>::mma(acc, da + 2 * kk, db + kk * (16 * AW * 2 >> 4));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (held) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (tid % 128 == 0) release(empty + 8 * ((g - 1) % G::STAGES), cluster);
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs<BN / 2>(acc);
      if (tid % 128 == 0) release(empty + 8 * ((g - 1) % G::STAGES), cluster);

      // `out` has rows up to a multiple of 128 and ldf (even) columns; a
      // block of a cluster past R stores nothing
      const long group = u / slabs;
      const long r = (group * cluster + rank) * BM + wg * 64 + ((tid % 128) / 32) * 16 +
                     lane / 4;
      float* o = out + r * ldf + (u % slabs) * BN + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (r < R)
          *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
        if (r + 8 < R)
          *reinterpret_cast<float2*>(o + 8 * ldf + 8 * j) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not the runtime: it is fetched
// through the runtime's entry-point query, so the library needs no link
// against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Map of a row-major bf16 [rows, cols] matrix in boxes of box_rows x 64
// with the 128-byte swizzle, zeros outside. Returns 0, or minus the CUresult.
int make_map(CUtensorMap* map, const void* ptr, long rows, long cols, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -999;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                   strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

template <int BN>
int launch_wgmma(const void* S, const int* starts, const void* F, float* out, int R,
                 int M, int cf, int band, int row_tile, int ldf, int cluster,
                 cudaStream_t stream) {
  using G = Cfg<BN>;
  CUtensorMap map_s, map_f;
  int err = make_map(&map_s, S, R, band, BM);
  if (!err) err = make_map(&map_f, F, M, cf, BK);
  if (err) return err;
  auto kernel = band_matmul_wgmma_kernel<BN>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       G::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int slabs = ldf / BN;
  const int units = (R + cluster * BM - 1) / (cluster * BM) * slabs;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = G::SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters (lone blocks) as fit on the card at once,
  // one block an SM
  int resident = 0;
  if (cluster > 1) {
    cfg.gridDim = dim3(cluster);
    e = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  } else {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&resident, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3((resident > 0 && resident < units ? resident : units) * cluster);
  e = cudaLaunchKernelEx(&cfg, kernel, map_s, map_f,
                         static_cast<const __nv_bfloat16*>(F), starts, out, R, M, cf,
                         band, row_tile, ldf, slabs, cluster, units);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers come from
// tensor.data_ptr(), the stream from torch.cuda.current_stream().cuda_stream.
// Each returns 0 when launched, a cudaError_t when a launch was refused, or
// minus a CUresult when a TMA descriptor could not be encoded.

// C <= 32: F is [M, 32] (the wrapper pads it), out [R rounded up to 128, 32].
extern "C" int band_matmul_wmma(const void* S, const void* starts, const void* F,
                                void* out, int R, int M, int band, int row_tile,
                                void* stream) {
  if (R <= 0) return 0;
  using T = Tile<32, 128, 8>;
  auto kernel = band_matmul_kernel<32, 128, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + 127) / 128, 1);
  kernel<<<grid, THREADS, T::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(S), static_cast<const int*>(starts),
      static_cast<const __nv_bfloat16*>(F), static_cast<float*>(out), R, M, band,
      row_tile, 32);
  return static_cast<int>(cudaGetLastError());
}

// C > 32: F is [M, cf] with cf a multiple of 8 (16-byte rows for TMA) and
// 16-byte aligned; out is [R rounded up to 128, ldf] with ldf = slabs * bn,
// bn one of WGMMA_COLS. `cluster` is 1, or 2 row blocks that share each F
// chunk (needs row_tile % 256 == 0).
extern "C" int band_matmul_wgmma(const void* S, const void* starts, const void* F,
                                 void* out, int R, int M, int cf, int band, int row_tile,
                                 int bn, int ldf, int cluster, void* stream) {
  if (R <= 0) return 0;
  if (M <= 0 || cf % 8 || bn <= 0 || ldf % bn ||
      (cluster != 1 && cluster != 2) || row_tile % (cluster * wg::BM))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* st_ptr = static_cast<const int*>(starts);
  float* o = static_cast<float*>(out);
  switch (bn) {
#define K1_CASE(N)                                                                       \
  case N:                                                                                \
    return wg::launch_wgmma<N>(S, st_ptr, F, o, R, M, cf, band, row_tile, ldf, cluster,  \
                               st);
    WGMMA_COLS(K1_CASE)
#undef K1_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
