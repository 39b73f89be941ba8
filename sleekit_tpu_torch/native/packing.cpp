// Native sub-byte weight packing for host-side checkpoint conversion
// (the port's copy of sleekit_tpu/native/packing.cpp).
//
// Packs per-element codebook indices into 32-bit words along the K axis
// (the "linear" layout of sleekit_tpu_torch/ops/pack.py: vals_per_word =
// 32/nbits for nbits 1, 2, 4 and 8, 10 sub-elements for 3-bit; other
// widths are refused). Converting a multi-billion-parameter checkpoint is
// a host-side bit-twiddling job; this implementation is multithreaded over
// word rows.
//
// C ABI only (consumed via ctypes - no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

int vals_per_word(int nbits) {
  if (nbits == 3) return 10;
  if (nbits <= 0 || nbits > 8 || 32 % nbits != 0) return 0;
  return 32 / nbits;
}

template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nthreads = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n));
  if (nthreads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Pack idx (k x n, row-major uint8) -> out (ceil(k/vpw) x n, row-major
// int32 bit patterns). Returns 0 on success, nonzero on bad arguments.
int skq_pack(const uint8_t* idx, int64_t k, int64_t n, int nbits,
             int32_t* out) {
  int vpw = vals_per_word(nbits);
  if (vpw == 0 || k < 0 || n <= 0) return 1;
  int64_t kw = (k + vpw - 1) / vpw;
  parallel_for(kw, [=](int64_t lo, int64_t hi) {
    for (int64_t g = lo; g < hi; ++g) {
      int64_t base = g * vpw;
      int64_t jmax = std::min<int64_t>(vpw, k - base);
      for (int64_t col = 0; col < n; ++col) {
        uint32_t word = 0;
        for (int64_t j = 0; j < jmax; ++j) {
          uint32_t v = idx[(base + j) * n + col];
          word |= (v & ((1u << nbits) - 1)) << (j * nbits);
        }
        uint32_t bits = word;
        std::memcpy(&out[g * n + col], &bits, sizeof(bits));
      }
    }
  });
  return 0;
}

// Unpack words (kw x n int32) -> idx (k x n uint8).
int skq_unpack(const int32_t* words, int64_t k, int64_t n, int nbits,
               uint8_t* idx) {
  int vpw = vals_per_word(nbits);
  if (vpw == 0 || k < 0 || n <= 0) return 1;
  int64_t kw = (k + vpw - 1) / vpw;
  uint32_t mask = (1u << nbits) - 1;
  parallel_for(kw, [=](int64_t lo, int64_t hi) {
    for (int64_t g = lo; g < hi; ++g) {
      int64_t base = g * vpw;
      int64_t jmax = std::min<int64_t>(vpw, k - base);
      for (int64_t col = 0; col < n; ++col) {
        uint32_t word;
        std::memcpy(&word, &words[g * n + col], sizeof(word));
        for (int64_t j = 0; j < jmax; ++j) {
          idx[(base + j) * n + col] =
              static_cast<uint8_t>((word >> (j * nbits)) & mask);
        }
      }
    }
  });
  return 0;
}

// Fused quantize-index + pack: normalized weights w (k x n f32, already
// divided by the per-column scale) are affine-rounded onto a uniform
// codebook grid (value = i*step + zero, i in [0, levels)) and packed.
int skq_quantize_pack_uniform(const float* w, int64_t k, int64_t n,
                              int nbits, int levels, float step, float zero,
                              int32_t* out) {
  int vpw = vals_per_word(nbits);
  if (vpw == 0 || levels < 2 || step <= 0) return 1;
  int64_t kw = (k + vpw - 1) / vpw;
  float inv_step = 1.0f / step;
  parallel_for(kw, [=](int64_t lo, int64_t hi) {
    for (int64_t g = lo; g < hi; ++g) {
      int64_t base = g * vpw;
      int64_t jmax = std::min<int64_t>(vpw, k - base);
      for (int64_t col = 0; col < n; ++col) {
        uint32_t word = 0;
        for (int64_t j = 0; j < jmax; ++j) {
          float x = (w[(base + j) * n + col] - zero) * inv_step;
          long q = std::lround(x);
          q = std::max(0l, std::min(static_cast<long>(levels - 1), q));
          word |= (static_cast<uint32_t>(q) & ((1u << nbits) - 1))
                  << (j * nbits);
        }
        std::memcpy(&out[g * n + col], &word, sizeof(word));
      }
    }
  });
  return 0;
}

}  // extern "C"
