// Native acceleration-structure builder for merian_quake_tpu.
//
// Host-side counterpart of the runtime components the reference keeps in
// C++ (Merian's DeviceASBuilder BLAS/TLAS build, quake_node.cpp:985-1012,
// and the per-frame geometry extraction thread pool,
// quake_node.cpp:896-983): per-frame work that must not sit on the Python
// interpreter. Computes Morton-ordered triangle permutations and cluster
// AABBs.
//
// Build: make -C native   (g++ -O3 -shared; no external dependencies)
// Python binding: ctypes (merian_quake_tpu/utils/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline uint64_t spread3(uint64_t v) {
  v &= 0x3ff;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

inline uint64_t morton3(uint32_t x, uint32_t y, uint32_t z) {
  return spread3(x) | (spread3(y) << 1) | (spread3(z) << 2);
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  // Simple static partition across hardware threads (≈ merian's
  // thread-pool parallel_for used for dynamic geometry).
  const int threads =
      std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
  if (n < 4096 || threads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Morton-order permutation: candidates first (rank 0), then valid
// non-candidates, then padding — matching accel/build.py.
// v0/v1/v2: float[T*3]; candidate/valid: uint8[T]; perm_out: int32[T].
void mq_morton_perm(const float* v0, const float* v1, const float* v2,
                    const uint8_t* candidate, const uint8_t* valid,
                    int64_t T, int32_t* perm_out) {
  std::vector<std::pair<uint64_t, int32_t>> keys(T);
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  std::vector<float> cent(T * 3);
  for (int64_t t = 0; t < T; ++t) {
    for (int k = 0; k < 3; ++k) {
      const float c =
          (v0[t * 3 + k] + v1[t * 3 + k] + v2[t * 3 + k]) / 3.0f;
      cent[t * 3 + k] = c;
      lo[k] = std::min(lo[k], c);
      hi[k] = std::max(hi[k], c);
    }
  }
  float ext[3];
  for (int k = 0; k < 3; ++k) ext[k] = std::max(hi[k] - lo[k], 1e-6f);
  parallel_for(T, [&](int64_t a, int64_t b) {
    for (int64_t t = a; t < b; ++t) {
      uint32_t q[3];
      for (int k = 0; k < 3; ++k) {
        float f = (cent[t * 3 + k] - lo[k]) / ext[k] * 1023.0f;
        q[k] = (uint32_t)std::min(std::max(f, 0.0f), 1023.0f);
      }
      const uint64_t rank = candidate[t] ? 0ull : (valid[t] ? 1ull : 2ull);
      keys[t] = {(rank << 62) | morton3(q[0], q[1], q[2]), (int32_t)t};
    }
  });
  std::stable_sort(keys.begin(), keys.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  for (int64_t t = 0; t < T; ++t) perm_out[t] = keys[t].second;
}

// Cluster AABBs over Morton-ordered candidate triangles.
// cluster_size divides T. lo_out/hi_out: float[(T/cluster)*3].
void mq_cluster_aabbs(const float* v0, const float* v1, const float* v2,
                      const uint8_t* candidate, int64_t T,
                      int64_t cluster_size, float* lo_out, float* hi_out) {
  const int64_t C = T / cluster_size;
  parallel_for(C, [&](int64_t a, int64_t b) {
    for (int64_t c = a; c < b; ++c) {
      float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
      for (int64_t t = c * cluster_size; t < (c + 1) * cluster_size; ++t) {
        if (!candidate[t]) continue;
        const float* vs[3] = {v0 + t * 3, v1 + t * 3, v2 + t * 3};
        for (const float* v : vs)
          for (int k = 0; k < 3; ++k) {
            lo[k] = std::min(lo[k], v[k]);
            hi[k] = std::max(hi[k], v[k]);
          }
      }
      for (int k = 0; k < 3; ++k) {
        lo_out[c * 3 + k] = lo[k];
        hi_out[c * 3 + k] = hi[k];
      }
    }
  });
}

int mq_version() { return 1; }

}  // extern "C"
