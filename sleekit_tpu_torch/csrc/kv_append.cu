// Kernels K10 and K14 of the port: the in-place append of one decode
// step's K/V into the cache of one layer, on its own (the split route).
//
// Replaces: sleekit_tpu/ops/attention.py  kv_append_pallas /
// _kv_append_uniform with _append_kernel, _append_q_kernel and their
// uniform-position variants (K10); sleekit_tpu/ops/paged_attention.py
// paged_kv_append_pallas (K14).
//
// It writes k_new/v_new (B, KV, D) at pos (a scalar or a (B,) vector,
// clamped to MAXP*PS - 1) of batch row b: into a slot cache (L, B, KV, S,
// D), or into a page pool (L, P, KV, PS, D) at page table[b, pos / PS],
// row pos % PS. Int8 caches quantize each (token, head) row first with a
// symmetric scale - max|x| / 127, x / scale exactly and rounded half to
// even, as the reference's _quant_rows - and store the scale, rounded to
// the plane's bf16 or f32, at the same row of the (L, P, KV, PS) planes.
//
// What bounds it on an H100: neither bytes nor operations. It reads the
// new K/V and writes one row per (batch row, head): about 0.1 MB at
// OPT-1.3B batch 8, 0.03 µs at 3.35 TB/s, so its time is the launch's.
//
// What the design does about it: one warp per (batch row, KV head, K or
// V) - lanes along D, the row's max by shuffles - so every row's load,
// reduction and stores run at once and the kernel's time is one memory
// round trip (a first version that walked 4 heads per warp in turn took
// 8 us on an H100 at OPT-1.3B batch 8). Each element is written by one
// store; the TPU kernels' 8-row window is a TPU tiling rule and has no
// counterpart here.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;

template <typename NT, typename CT, typename ST, bool QUANT>
__global__ void __launch_bounds__(THREADS) append_kernel(
    const NT* k_new, const NT* v_new, CT* cache_k, CT* cache_v, ST* k_scale,
    ST* v_scale, const int* pos_ptr, const int* table, int pos_scalar,
    int layer, int B, int KV, int P, int PS, int MAXP, int D) {
  const int w = blockIdx.x * NWARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= B * KV * 2) return;
  const int which = w % 2, h = (w / 2) % KV, b = w / (2 * KV);
  int p = pos_ptr ? pos_ptr[b] : pos_scalar;
  p = min(max(p, 0), MAXP * PS - 1);
  const int page = table ? table[b * MAXP + p / PS] : b;
  const size_t r = (((size_t)layer * P + page) * KV + h) * PS + p % PS;
  const NT* src = (which ? v_new : k_new) + ((size_t)b * KV + h) * D;
  CT* dst = (which ? cache_v : cache_k) + r * D;
  if constexpr (QUANT) {
    float amax = 0.0f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f(src[d])));
    const float sc = fmaxf(warp_max(amax) / 127.0f, 1e-8f);
    for (int d = lane; d < D; d += 32)
      dst[d] = (int8_t)fminf(fmaxf(rintf(to_f(src[d]) / sc), -127.0f), 127.0f);
    if (lane == 0) (which ? v_scale : k_scale)[r] = from_f<ST>(sc);
  } else {
    for (int d = lane; d < D; d += 32) dst[d] = from_f<CT>(to_f(src[d]));
  }
}

struct Launch {
  const void *k_new, *v_new;
  void *cache_k, *cache_v, *k_scale, *v_scale;
  const int *pos, *table;
  int pos_scalar, layer, B, KV, P, PS, MAXP, D;
};

template <typename NT, typename CT, typename ST, bool QUANT>
int launch(const Launch& a, cudaStream_t stream) {
  const int blocks = (a.B * a.KV * 2 + NWARPS - 1) / NWARPS;
  append_kernel<NT, CT, ST, QUANT><<<blocks, THREADS, 0, stream>>>(
      static_cast<const NT*>(a.k_new), static_cast<const NT*>(a.v_new),
      static_cast<CT*>(a.cache_k), static_cast<CT*>(a.cache_v),
      static_cast<ST*>(a.k_scale), static_cast<ST*>(a.v_scale), a.pos,
      a.table, a.pos_scalar, a.layer, a.B, a.KV, a.P, a.PS, a.MAXP, a.D);
  return (int)cudaGetLastError();
}

template <typename NT>
int launch_n(const Launch& a, int cache_kind, int scale_bf16,
             cudaStream_t s) {
  switch (cache_kind) {
    case 0:
      return scale_bf16 ? launch<NT, int8_t, bf16, true>(a, s)
                        : launch<NT, int8_t, float, true>(a, s);
    case 1: return launch<NT, bf16, float, false>(a, s);
    case 2: return launch<NT, float, float, false>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// k_new/v_new (B, KV, D) bf16/f32; caches (L, P, KV, PS, D) int8
// (cache_kind 0, with (L, P, KV, PS) bf16/f32 scale planes), bf16 (1) or
// f32 (2); table (B, MAXP) int32, or null for a slot cache (then P = B,
// PS = S, MAXP = 1); pos (B,) int32 or null (then pos_scalar).
extern "C" int kv_append(const void* k_new, const void* v_new, void* cache_k,
                         void* cache_v, void* k_scale, void* v_scale,
                         const void* pos, const void* table, int pos_scalar,
                         int layer, int B, int KV, int P, int PS, int MAXP,
                         int D, int new_bf16, int cache_kind, int scale_bf16,
                         void* stream) {
  Launch a{k_new, v_new, cache_k, cache_v, k_scale, v_scale,
           static_cast<const int*>(pos), static_cast<const int*>(table),
           pos_scalar, layer, B, KV, P, PS, MAXP, D};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return new_bf16 ? launch_n<bf16>(a, cache_kind, scale_bf16, s)
                  : launch_n<float>(a, cache_kind, scale_bf16, s);
}
