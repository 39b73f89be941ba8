// Kernel K10 of the port, and K14 on its body: the in-place write of T
// rows of K/V a (batch row, KV head) into the cache of one layer. At T = 1
// it is the split route's decode append (K10 into the slot cache, K14
// through the page table); at T = the prompt length it is the prefill's
// KV write, which also gives the attention its dequantized K/V.
//
// Replaces: sleekit_tpu/ops/attention.py  kv_append_pallas /
// _kv_append_uniform with _append_kernel, _append_q_kernel and their
// uniform-position variants (K10); sleekit_tpu/ops/paged_attention.py
// paged_kv_append_pallas (K14); and the XLA ops of the prefill branch of
// sleekit_tpu/models/transformer.py (_quant_rows, dynamic_update_slice,
// the scale planes and the dequantized cache rows), which fuse on the TPU.
//
// Row t of batch row b goes to logical cache row p = clamp(pos_b, 0,
// MAXP*PS - T) + t (pos a scalar or a (B,) vector): of a slot cache (L, B,
// KV, S, D), or of a page pool (L, P, KV, PS, D) at page table[b, p / PS],
// row p % PS. The inputs are (B, T, KV, D) views with any batch, token and
// head strides and unit stride along D (the fused qkv output's slices).
// Int8 caches quantize each row as the reference's _quant_rows does -
// scale = max(max|x| / 127, 1e-8) and q = clamp(rint(x / scale), -127,
// 127), both IEEE f32 divisions (the build has no --use_fast_math) - and
// store the scale rounded to the plane's bf16 or f32; with an output, the
// row is also written dequantized, f32(q) * f32(stored scale) rounded to
// the input's dtype, into a contiguous (B, KV, T, D) tensor.
//
// What bounds it on an H100: bytes. At prefill (OPT-1.3B's 256-bucket
// group, B 4, T 256, KV 32, D 64) it reads 8.4 MB of bf16 K/V and writes
// 4.2 MB of int8 rows, 0.13 MB of scales and 8.4 MB of dequantized rows:
// 6.3 us at 3.35 TB/s. At T = 1 (0.1 MB) its time is the launch's.
//
// What the design does about it: every lane moves 16 bytes a load (E
// elements), so a bf16 row of D 64 is 8 lanes and a warp 4 rows; a
// narrower E where a row's bytes, strides or pointers are not 16-byte
// aligned, and at T = 1, where a row takes up to 32 lanes so that each
// divides fewer values by the scale. The row max is a few xor shuffles
// within a row's lanes, and each row's values stay in registers between
// the max and the quantization. A block is R rows: at T > 1, 32
// consecutive t of one (b, K|V, h), so its cache rows and dequantized rows
// are contiguous runs and its 32 scales one contiguous store (gathered in
// shared memory); at T = 1, the B*KV*2 rows over about as many blocks as
// the card has SMs.
#include "common.cuh"

namespace {

constexpr int MAX_R = 32;

struct Args {
  const void *k, *v;
  void *cache_k, *cache_v, *k_scale, *v_scale, *out_k, *out_v;
  const int *pos, *table;
  long long sb, st, sh;      // input strides (elements): batch, token, head
  int pos_scalar, layer, B, T, KV, P, PS, MAXP, D;
  int lpr_log, R, TP;        // log2 lanes a row, rows a block, T padded to R
};

template <int N> struct Raw;
template <> struct Raw<16> { typedef uint4 T; };
template <> struct Raw<8> { typedef uint2 T; };
template <> struct Raw<4> { typedef unsigned T; };
template <> struct Raw<2> { typedef unsigned short T; };
template <> struct Raw<1> { typedef unsigned char T; };

// N bytes from src to dst in pieces of at most 16, both aligned to the
// piece.
template <int N>
__device__ __forceinline__ void copy_bytes(void* dst, const void* src) {
  constexpr int PIECE = N < 16 ? N : 16;
  typedef typename Raw<PIECE>::T W;
#pragma unroll
  for (int i = 0; i < N / PIECE; ++i)
    static_cast<W*>(dst)[i] = static_cast<const W*>(src)[i];
}

// NT input, CT cache, ST scale plane; E elements a chunk, NCH chunks a
// lane (chunk c of a row is read by lane c % lpr, lpr = 2^lpr_log).
template <typename NT, typename CT, typename ST, bool QUANT, int E, int NCH>
__global__ void __launch_bounds__(1024) append_kernel(const Args a) {
  __shared__ float sc_s[MAX_R];
  __shared__ long long row_s[MAX_R];
  // 32-bit index arithmetic (the launch checks that it fits): 64-bit
  // divisions would sit on every row's path to its first load.
  const int lpr = 1 << a.lpr_log;
  const int local = threadIdx.x >> a.lpr_log, lane = threadIdx.x & (lpr - 1);
  const int f = blockIdx.x * a.R + local;
  const int g = a.TP == 1 ? f : f / a.TP;        // (b, K|V, h)
  const int t = f - g * a.TP;
  const int h = g % a.KV, bw = g / a.KV, which = bw & 1, b = bw >> 1;
  const bool valid = b < a.B && t < a.T;
  const int CH = a.D / E;

  long long r = 0;
  alignas(16) NT x[NCH][E];
  if (valid) {
    const NT* src = static_cast<const NT*>(which ? a.v : a.k) + b * a.sb +
                    t * a.st + h * a.sh;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = lane + j * lpr;
      if (c < CH) copy_bytes<E * sizeof(NT)>(x[j], src + c * E);
    }
    int p = a.pos ? a.pos[b] : a.pos_scalar;
    p = min(max(p, 0), a.MAXP * a.PS - a.T) + t;
    const int page = a.table ? a.table[b * a.MAXP + p / a.PS] : b;
    r = (((long long)a.layer * a.P + page) * a.KV + h) * a.PS + p % a.PS;
  }
  if constexpr (QUANT) {
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      if (valid && lane + j * lpr < CH)
#pragma unroll
        for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(to_f(x[j][e])));
    // The lanes of a row are lpr consecutive lanes of one warp; every
    // lane of the block takes part (lpr divides 32, R * lpr is a multiple
    // of 32).
    for (int o = lpr / 2; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sc = fmaxf(amax / 127.0f, 1e-8f);
    const float stored = to_f(from_f<ST>(sc));
    NT* out = static_cast<NT*>(which ? a.out_v : a.out_k);
    if (valid) {
      int8_t* dst = static_cast<int8_t*>(which ? a.cache_v : a.cache_k) +
                    r * a.D;
      NT* deq = out ? out + ((((long long)b * a.KV + h) * a.T + t) * a.D)
                    : nullptr;
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        const int c = lane + j * lpr;
        if (c >= CH) continue;
        alignas(16) int8_t q[E];
        alignas(16) NT d[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float qf =
              fminf(fmaxf(rintf(to_f(x[j][e]) / sc), -127.0f), 127.0f);
          q[e] = (int8_t)qf;
          d[e] = from_f<NT>((float)q[e] * stored);   // +0, never -0
        }
        copy_bytes<E>(dst + c * E, q);
        if (deq) copy_bytes<E * sizeof(NT)>(deq + c * E, d);
      }
    }
    if (a.T == 1) {
      // Rows of different (b, h): each stores its own scale.
      if (lane == 0 && valid)
        static_cast<ST*>(which ? a.v_scale : a.k_scale)[r] = from_f<ST>(sc);
    } else {
      // R consecutive rows of one (b, K|V, h): one contiguous store.
      if (lane == 0) {
        sc_s[local] = sc;
        row_s[local] = valid ? r : -1;
      }
      __syncthreads();
      if (threadIdx.x < a.R && row_s[threadIdx.x] >= 0)
        static_cast<ST*>(which ? a.v_scale : a.k_scale)[row_s[threadIdx.x]] =
            from_f<ST>(sc_s[threadIdx.x]);
    }
  } else if (valid) {
    CT* dst = static_cast<CT*>(which ? a.cache_v : a.cache_k) + r * a.D;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = lane + j * lpr;
      if (c >= CH) continue;
      alignas(16) CT y[E];
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = from_f<CT>(to_f(x[j][e]));
      copy_bytes<E * sizeof(CT)>(dst + c * E, y);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename NT, typename CT, typename ST, bool QUANT, int E>
int launch(Args a, cudaStream_t stream) {
  const int CH = a.D / E;
  a.lpr_log = 0;
  while ((1 << a.lpr_log) < CH && a.lpr_log < 5) ++a.lpr_log;
  const int lpr = 1 << a.lpr_log;
  const int nch = (CH + lpr - 1) / lpr;         // 1 to 8
  const long long groups = 2LL * a.B * a.KV;
  if (a.T > 1) {
    a.R = MAX_R;
    a.TP = (a.T + MAX_R - 1) / MAX_R * MAX_R;
  } else {
    // About one block an SM, each at least a warp and at most MAX_R rows.
    const long long want = (groups + sm_count() - 1) / sm_count();
    a.R = 32 / lpr;
    while (a.R < want && a.R < MAX_R) a.R *= 2;
    a.TP = 1;
  }
  const long long blocks = (groups * a.TP + a.R - 1) / a.R;
  if (blocks * a.R >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  void (*kernel)(const Args) =
      nch == 1   ? append_kernel<NT, CT, ST, QUANT, E, 1>
      : nch == 2 ? append_kernel<NT, CT, ST, QUANT, E, 2>
      : nch <= 4 ? append_kernel<NT, CT, ST, QUANT, E, 4>
                 : append_kernel<NT, CT, ST, QUANT, E, 8>;
  kernel<<<(unsigned)blocks, a.R * lpr, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename NT, int E>
int launch_kind(const Args& a, int cache_kind, int scale_bf16,
                cudaStream_t s) {
  switch (cache_kind) {
    case 0:
      return scale_bf16 ? launch<NT, int8_t, bf16, true, E>(a, s)
                        : launch<NT, int8_t, float, true, E>(a, s);
    case 1: return launch<NT, bf16, float, false, E>(a, s);
    case 2: return launch<NT, float, float, false, E>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename NT>
int launch_vec(const Args& a, int vec, int cache_kind, int scale_bf16,
               cudaStream_t s) {
  switch (vec) {
    case 1: return launch_kind<NT, 1>(a, cache_kind, scale_bf16, s);
    case 2: return launch_kind<NT, 2>(a, cache_kind, scale_bf16, s);
    case 4: return launch_kind<NT, 4>(a, cache_kind, scale_bf16, s);
    case 8:
      if constexpr (sizeof(NT) == 2)
        return launch_kind<NT, 8>(a, cache_kind, scale_bf16, s);
      else
        return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// k/v (B, T, KV, D) bf16/f32 at element strides (sb, st, sh, 1); caches
// (L, P, KV, PS, D) int8 (cache_kind 0, with (L, P, KV, PS) bf16/f32 scale
// planes), bf16 (1) or f32 (2); table (B, MAXP) int32, or null for a slot
// cache (then P = B, PS = S, MAXP = 1); pos (B,) int32 or null (then
// pos_scalar); out_k/out_v (B, KV, T, D) in k's dtype, or null (int8 only:
// the dequantized rows). vec: elements a 16-byte or narrower chunk, which
// must divide D, the strides and the pointers' alignment.
extern "C" int kv_append(const void* k, const void* v, void* cache_k,
                         void* cache_v, void* k_scale, void* v_scale,
                         void* out_k, void* out_v, const void* pos,
                         const void* table, long long sb, long long st,
                         long long sh, int pos_scalar, int layer, int B,
                         int T, int KV, int P, int PS, int MAXP, int D,
                         int vec, int in_bf16, int cache_kind,
                         int scale_bf16, void* stream) {
  Args a{k, v, cache_k, cache_v, k_scale, v_scale, out_k, out_v,
         static_cast<const int*>(pos), static_cast<const int*>(table),
         sb, st, sh, pos_scalar, layer, B, T, KV, P, PS, MAXP, D, 0, 0, 0};
  if (T < 1 || T > MAXP * PS || vec < 1 || D % vec != 0 ||
      D / vec > 32 * 8)
    return (int)cudaErrorInvalidValue;
  // One row a (batch row, head) is bound by its launch and its chain of
  // dependent steps, not by its bytes: up to 32 lanes a row, so each lane
  // divides fewer values by the scale (IEEE divisions, one after another).
  if (T == 1)
    while (vec > 1 && D / vec < 32) vec /= 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_bf16 ? launch_vec<bf16>(a, vec, cache_kind, scale_bf16, s)
                 : launch_vec<float>(a, vec, cache_kind, scale_bf16, s);
}
