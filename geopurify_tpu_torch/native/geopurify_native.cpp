// geopurify_native — C++ host-side preprocessing kernels.
//
// The port's own copy of geopurify_tpu/native/geopurify_native.cpp (the
// same functions, the same C ABI): FNV-1a voxel dedup, occlusion-tested
// point->pixel projection, face-normal accumulation, a brute-force top-1
// neighbour fill and an exact kNN over integer grid cells. Loaded through
// ctypes by geopurify_tpu_torch/native/__init__.py, which builds it at
// first use; every function has a numpy counterpart with identical
// semantics, pinned by tests/test_torch_port_native.py.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 14695981039346656037ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;

inline uint64_t fnv1a_row(const int64_t* row, int d) {
  uint64_t h = kFnvOffset;
  for (int j = 0; j < d; ++j) {
    h *= kFnvPrime;             // matches the numpy reference: mul THEN xor
    h ^= static_cast<uint64_t>(row[j]);
  }
  return h;
}

void parallel_for(int64_t n, int64_t grain,
                  const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>(hw, n / grain));
  if (n_threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// FNV-1a 64-bit hash of floored int coordinates, one per row.
void fnv_hash_rows(const int64_t* coords, int64_t n, int32_t d, uint64_t* out) {
  parallel_for(n, 1 << 14, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) out[i] = fnv1a_row(coords + i * d, d);
  });
}

// Dedup rows by FNV hash with np.unique semantics:
//   voxel ids ordered by ASCENDING hash key;
//   inds[v]        = first-occurrence row index of voxel v;
//   inds_reverse[i] = voxel id of row i.
// Returns the number of unique voxels m (<= n).
int64_t fnv_voxelize(const int64_t* coords, int64_t n, int32_t d,
                     int64_t* inds, int64_t* inds_reverse) {
  std::vector<uint64_t> keys(n);
  fnv_hash_rows(coords, n, d, keys.data());

  std::unordered_map<uint64_t, int64_t> first;  // key -> first row idx
  first.reserve(static_cast<size_t>(n * 1.3));
  for (int64_t i = 0; i < n; ++i) {
    auto it = first.find(keys[i]);
    if (it == first.end()) first.emplace(keys[i], i);
  }
  int64_t m = static_cast<int64_t>(first.size());

  std::vector<std::pair<uint64_t, int64_t>> uniq(first.begin(), first.end());
  std::sort(uniq.begin(), uniq.end());
  std::unordered_map<uint64_t, int64_t> rank;
  rank.reserve(uniq.size() * 2);
  for (int64_t v = 0; v < m; ++v) {
    inds[v] = uniq[v].second;
    rank.emplace(uniq[v].first, v);
  }
  parallel_for(n, 1 << 14, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) inds_reverse[i] = rank.at(keys[i]);
  });
  return m;
}

// Occlusion-tested pinhole projection (fusion_util.py:99-147 semantics;
// identical to loaders.compute_mapping_np).
//   points [n,3] f32 (world), w2c [4,4] f64 row-major, K [3,3] f64,
//   depth [H,W] f32 in metres or nullptr, outputs rows/cols int32 + vis u8.
void compute_mapping(const float* points, int64_t n, const double* w2c,
                     const double* K, const float* depth, int32_t W, int32_t H,
                     int32_t cut, double vis_thres, int32_t* rows,
                     int32_t* cols, uint8_t* visible) {
  const double fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  parallel_for(n, 1 << 13, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const double x = points[i * 3], y = points[i * 3 + 1], z0 = points[i * 3 + 2];
      const double px = w2c[0] * x + w2c[1] * y + w2c[2] * z0 + w2c[3];
      const double py = w2c[4] * x + w2c[5] * y + w2c[6] * z0 + w2c[7];
      const double pz = w2c[8] * x + w2c[9] * y + w2c[10] * z0 + w2c[11];
      const double sz = std::abs(pz) < 1e-8 ? 1e-8 : pz;
      // round-half-even (numpy np.round semantics; llround would differ on
      // exact .5 pixel coordinates). nearbyint honours the default FE mode,
      // which is round-to-nearest-even.
      const int64_t u = static_cast<int64_t>(std::nearbyint(px * fx / sz + cx));
      const int64_t v = static_cast<int64_t>(std::nearbyint(py * fy / sz + cy));
      bool ok = u >= cut && v >= cut && u < W - cut && v < H - cut && pz > 0;
      if (ok && depth != nullptr) {
        const double d = depth[v * W + u];
        ok = d > 0 && std::abs(d - pz) <= vis_thres * d;
      }
      visible[i] = ok ? 1 : 0;
      rows[i] = ok ? static_cast<int32_t>(v) : 0;
      cols[i] = ok ? static_cast<int32_t>(u) : 0;
    }
  });
}

// Accumulate unnormalized (area-weighted) face normals onto vertices.
// xyz [nv,3] f32, faces [nf,3] i64, out [nv,3] f64 (pre-zeroed by caller).
void accumulate_face_normals(const float* xyz, int64_t nv, const int64_t* faces,
                             int64_t nf, double* out) {
  (void)nv;
  for (int64_t f = 0; f < nf; ++f) {
    const int64_t i0 = faces[f * 3], i1 = faces[f * 3 + 1], i2 = faces[f * 3 + 2];
    double ax = xyz[i1 * 3] - xyz[i0 * 3];
    double ay = xyz[i1 * 3 + 1] - xyz[i0 * 3 + 1];
    double az = xyz[i1 * 3 + 2] - xyz[i0 * 3 + 2];
    double bx = xyz[i2 * 3] - xyz[i0 * 3];
    double by = xyz[i2 * 3 + 1] - xyz[i0 * 3 + 1];
    double bz = xyz[i2 * 3 + 2] - xyz[i0 * 3 + 2];
    const double nx = ay * bz - az * by;
    const double ny = az * bx - ax * bz;
    const double nz = ax * by - ay * bx;
    for (int64_t k : {i0, i1, i2}) {
      out[k * 3] += nx;
      out[k * 3 + 1] += ny;
      out[k * 3 + 2] += nz;
    }
  }
}

// Brute-force nearest valid donor (top-1 by squared L2 over 3-d coords):
// for every query i with has_value[i]==0, find argmin_j ||c_i - c_j|| over
// donors (has_value[j]==1) and write donor index; donors map to themselves.
void nearest_donor(const float* coords, int64_t n, const uint8_t* has_value,
                   int64_t* donor_idx) {
  std::vector<int64_t> donors;
  donors.reserve(n);
  for (int64_t j = 0; j < n; ++j)
    if (has_value[j]) donors.push_back(j);
  if (donors.empty()) {
    for (int64_t i = 0; i < n; ++i) donor_idx[i] = i;
    return;
  }
  parallel_for(n, 1 << 9, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (has_value[i]) {
        donor_idx[i] = i;
        continue;
      }
      const float qx = coords[i * 3], qy = coords[i * 3 + 1], qz = coords[i * 3 + 2];
      double best = 1e300;
      int64_t arg = donors[0];
      for (int64_t j : donors) {
        const double dx = coords[j * 3] - qx;
        const double dy = coords[j * 3 + 1] - qy;
        const double dz = coords[j * 3 + 2] - qz;
        const double d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best) {
          best = d2;
          arg = j;
        }
      }
      donor_idx[i] = arg;
    }
  });
}

// Exact k-nearest-neighbors over unique integer grid cells (voxels) by
// expanding Chebyshev shells around each cell with hash-map lookups —
// O(k + shell overshoot) per voxel instead of O(M) brute force. Exact: the
// search stops once >= k candidates are found AND the k-th Euclidean distance
// is <= r (any cell with Chebyshev radius > r has Euclidean distance > r).
// coords [m,3] int32 (unique cells), out_idx [m,k] int64 (-1 where fewer than
// k neighbors exist), out_d2 [m,k] float (same order, ascending).
void grid_knn(const int32_t* coords, int64_t m, int32_t k, int64_t* out_idx,
              float* out_d2) {
  // collision-free packed key; +2^14 offset keeps shell probes (which go
  // below 0 at the grid boundary) non-negative within each 21-bit field.
  // Valid input range: x,y,z in [-16384, 2080768) — asserted by the python
  // wrapper; the top bit (63) of a key is never set, so ~0 is a free sentinel.
  auto key_of = [](int32_t x, int32_t y, int32_t z) -> uint64_t {
    const uint64_t ox = static_cast<uint64_t>(x + 16384) & 0x1FFFFF;
    const uint64_t oy = static_cast<uint64_t>(y + 16384) & 0x1FFFFF;
    const uint64_t oz = static_cast<uint64_t>(z + 16384) & 0x1FFFFF;
    return (ox << 42) | (oy << 21) | oz;
  };
  constexpr uint64_t kEmpty = ~0ull;  // unreachable: bit 63 never set by key_of
  // flat open-addressing table (linear probing): the probe loop is the whole
  // cost of this algorithm and std::unordered_map is ~5x slower per lookup
  size_t cap = 64;
  while (cap < static_cast<size_t>(m) * 4) cap <<= 1;
  const size_t mask = cap - 1;
  std::vector<uint64_t> tab_key(cap, kEmpty);
  std::vector<int64_t> tab_val(cap);
  auto slot_of = [&](uint64_t key) -> size_t {
    uint64_t h = key * 0x9E3779B97F4A7C15ull;
    return static_cast<size_t>(h >> 1) & mask;
  };
  for (int64_t i = 0; i < m; ++i) {
    const uint64_t key = key_of(coords[i * 3], coords[i * 3 + 1], coords[i * 3 + 2]);
    size_t s = slot_of(key);
    while (tab_key[s] != kEmpty) s = (s + 1) & mask;
    tab_key[s] = key;
    tab_val[s] = i;
  }
  auto lookup = [&](uint64_t key) -> int64_t {
    size_t s = slot_of(key);
    while (true) {
      const uint64_t kk = tab_key[s];
      if (kk == key) return tab_val[s];
      if (kk == kEmpty) return -1;
      s = (s + 1) & mask;
    }
  };

  parallel_for(m, 1 << 8, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<int64_t, int64_t>> cand;  // (d2, idx)
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t cx = coords[i * 3], cy = coords[i * 3 + 1], cz = coords[i * 3 + 2];
      cand.clear();
      int64_t kth_d2 = -1;
      for (int32_t r = 1; r < (1 << 14); ++r) {
        // scan the shell at Chebyshev radius r
        for (int32_t dx = -r; dx <= r; ++dx) {
          for (int32_t dy = -r; dy <= r; ++dy) {
            const bool face_xy = (dx == -r || dx == r || dy == -r || dy == r);
            const int32_t step = face_xy ? 1 : 2 * r;  // interior: only dz=+-r
            for (int32_t dz = -r; dz <= r; dz += step) {
              const int64_t hit = lookup(key_of(cx + dx, cy + dy, cz + dz));
              if (hit >= 0 && hit != i) {
                const int64_t d2 = static_cast<int64_t>(dx) * dx +
                                   static_cast<int64_t>(dy) * dy +
                                   static_cast<int64_t>(dz) * dz;
                cand.emplace_back(d2, hit);
              }
            }
          }
        }
        if (static_cast<int64_t>(cand.size()) >= k) {
          std::nth_element(cand.begin(), cand.begin() + (k - 1), cand.end());
          kth_d2 = cand[k - 1].first;
          if (kth_d2 <= static_cast<int64_t>(r) * r) break;  // certified exact
        }
        if (static_cast<int64_t>(cand.size()) >= m - 1) break;  // everything seen
      }
      const int64_t take = std::min<int64_t>(k, cand.size());
      std::partial_sort(cand.begin(), cand.begin() + take, cand.end());
      for (int64_t j = 0; j < k; ++j) {
        if (j < take) {
          out_idx[i * k + j] = cand[j].second;
          out_d2[i * k + j] = static_cast<float>(cand[j].first);
        } else {
          out_idx[i * k + j] = -1;
          out_d2[i * k + j] = std::numeric_limits<float>::infinity();
        }
      }
    }
  });
}

}  // extern "C"
