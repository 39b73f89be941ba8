// Kernels K1, K6, K7 and K2 of the port: fused prologue + dequantize +
// matmul + epilogue over packed weights.
//
// Replaces:
//   K1  sleekit_tpu/ops/dequant_matmul.py  _pallas_pair_impl / _pair_kernel
//       ('pair' layout, 1..7-bit indices, two bf16 mantissas per int32 word)
//   K6  the same, p3x=True ('pair3x': per 512 K rows, 32 words of 4-bit
//       fields, then one 'pair3' tile)
//   K7  the same, pair3=True ('pair3': per 256 K rows, 16 words of 2-bit
//       low planes and 8 words of 1-bit high planes, idx = lo + 4*hi)
//   K2  sleekit_tpu/ops/dequant_matmul.py  _pallas_int8_impl
//       ('int8' layout, signed bytes idx-128, N padded at pack time)
// All compute
//   out = [res +] (a * (pre(x) @ W) + b * rowsum(pre(x))) * scale + bias
// with pre = none | layernorm | rmsnorm (statistics over the valid K) |
// relu | gelu (tanh) | silu_glu ([gate | up] halves of x), pre(x) rounded
// to bf16, rowsum over that bf16 pre(x), f32 accumulation, bf16 out.
//
// What bounds it on an H100: at decode (M = 8) the packed weight stream
// (K*N*nbits/8 bytes; 8 MB for OPT-1.3B fc1) over device memory, a few
// microseconds per projection; at prefill M the products on the CUDA cores.
//
// What the design does about it: every weight word is read once per
// M tile, coalesced along N (16 consecutive columns per half-warp), and
// decoded in registers - one shift, AND, OR per plane gives the bf16 bit
// patterns C = 1 + idx/2^nbits of two K rows at once; the affine codebook
// is folded into the epilogue, so no dequantized weight ever exists. The
// product runs over C - 1.5 (one exact subtraction): over C itself, the
// fold a*acc + b*rowsum cancels catastrophically when x has a large mean
// (after relu, rowsum ~ 2000 against a result ~ 7 at OPT-1.3B's fc2), and
// the f32 rounding of acc then flips about one bf16 output in ten.
// K6 and K7 are K1's body under another tile rule (the template parameter
// P): the same prologue, 512-row chunks and epilogue, 32 K rows per thread
// per chunk, one FMA per K row. A pair3 index keeps its 2 low bits in low
// word p (rows j*32 + 2p + h) and its high bit in high word p % 8, plane
// 2j + p/8 (the same rows), so the thread of K slice p loads both words
// and ORs the two parts into one bf16 mantissa, C = 1 + idx/8; pair3x's
// 4-bit fields give 4 + idx/4 as the TPU kernel builds them. Each value
// goes into the product minus its midpoint (2*(C - 1.4375) and
// 4 + idx/4 - 4.875, both idx/4 - 0.875, exact), so both layouts fold
// a = 4*step and b = zero + 3.5*step. The TPU kernel's pair3x epilogue
// instead subtracts a section-weighted rowsum from a*acc, two large,
// nearly equal terms.
// Each block owns 16 columns at decode (M <= 8; 64 at prefill M, and for
// K2) and one M tile of 8 or 16 rows; its 256 threads split K 16 ways and
// sum the slices through shared memory at the end. pre(x) of the block's
// rows is built chunk by chunk in shared memory, row-minor, so one 16-byte
// load serves four rows. This is the simple first version: CUDA-core FMAs,
// no tensor cores, no TMA, no split-K across blocks (N = 2048 projections
// fill 128 of 132 SMs at decode), and every block recomputes its rows'
// norm statistics.
#include "common.cuh"

namespace {

enum Pre { PRE_NONE = 0, PRE_LN = 1, PRE_RMS = 2, PRE_RELU = 3, PRE_GELU = 4,
           PRE_GLU = 5 };

constexpr int THREADS = 256;
constexpr int KSPLIT = 16;   // K slices (threads along K) per block
constexpr int BN = 16;       // threads along N per block
constexpr int NWARPS = THREADS / 32;
constexpr int CK8 = 128;     // K rows per chunk of the int8 kernel

struct Args {
  const bf16* x;
  const void* w;
  const float* scale;
  const float* bias;
  const void* ln_s;
  const void* ln_b;
  int ln_bf16;
  const bf16* res;
  bf16* out;
  int M, N, K, x_cols, kw, ld_w, pre;
  float a, b, eps;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// pre(x)[m, k] for k < K from x[m, k] = v, as the bf16 value the product
// uses; u is the up half x[m, K + k] for silu_glu, ls/lb the norm's scale
// and bias at k (lb 0 without a bias).
__device__ __forceinline__ float prologue(const Args& g, float v, float u,
                                          float ls, float lb, float mu,
                                          float rstd) {
  switch (g.pre) {
    case PRE_LN:
    case PRE_RMS:  // mu is 0 for rmsnorm
      return round_bf16((v - mu) * rstd * ls + lb);
    case PRE_RELU:
      return fmaxf(v, 0.0f);
    case PRE_GELU:
      return round_bf16(gelu_tanh(v));
    case PRE_GLU:
      return round_bf16(v * (1.0f / (1.0f + expf(-v))) * u);
    default:
      return v;
  }
}

// LOADS independent loads in flight per lane: the row walks are bound by
// load latency, not bandwidth.
constexpr int LOADS = 8;

// Row statistics of the norm prologues over the valid K: mean (layernorm)
// and 1/sqrt(var + eps); one warp per row.
template <int BM>
__device__ void row_stats(const Args& g, int m0, float* mu, float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < BM; m += NWARPS) {
    float mean = 0.0f, r = 0.0f;
    if (m0 + m < g.M) {
      const bf16* row = g.x + (size_t)(m0 + m) * g.x_cols;
      float s = 0.0f, s2 = 0.0f;
      if (g.pre == PRE_LN) {
        for (int k0 = 0; k0 < g.K; k0 += 32 * LOADS) {
          float v[LOADS];
#pragma unroll
          for (int i = 0; i < LOADS; ++i) {
            const int k = k0 + lane + 32 * i;
            v[i] = k < g.K ? to_f(row[k]) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < LOADS; ++i) s += v[i];
        }
        mean = warp_sum(s) / (float)g.K;
      }
      for (int k0 = 0; k0 < g.K; k0 += 32 * LOADS) {
        float v[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const int k = k0 + lane + 32 * i;
          v[i] = k < g.K ? to_f(row[k]) - mean : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < LOADS; ++i) s2 += v[i] * v[i];
      }
      r = 1.0f / sqrtf(warp_sum(s2) / (float)g.K + g.eps);
    }
    if (lane == 0) {
      mu[m] = mean;
      rstd[m] = r;
    }
  }
}

// xs[c * BM + m] = pre(x)[m0 + m, k0 + c] for c < ck (0 past K or M), and
// rs[m] += the chunk's row sums. One warp per row, lanes along K.
template <int BM>
__device__ void fill_chunk(const Args& g, int m0, int k0, int ck, float* xs,
                           const float* mu, const float* rstd, float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool glu = g.pre == PRE_GLU;
  const bool norm = g.pre == PRE_LN || g.pre == PRE_RMS;
  for (int m = warp; m < BM; m += NWARPS) {
    const bool row_ok = m0 + m < g.M;
    const bf16* row = g.x + (size_t)(m0 + m) * g.x_cols;
    float part = 0.0f;
    for (int c0 = 0; c0 < ck; c0 += 32 * LOADS) {
      // All of the batch's loads first, then the arithmetic.
      float v[LOADS], u[LOADS], ls[LOADS], lb[LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int c = c0 + lane + 32 * i, k = k0 + c;
        const bool ok = row_ok && c < ck && k < g.K;
        v[i] = ok ? to_f(row[k]) : 0.0f;
        u[i] = ok && glu ? to_f(row[g.K + k]) : 0.0f;
        ls[i] = ok && norm ? load_param(g.ln_s, k, g.ln_bf16) : 0.0f;
        lb[i] = ok && norm && g.ln_b ? load_param(g.ln_b, k, g.ln_bf16)
                                     : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int c = c0 + lane + 32 * i, k = k0 + c;
        const float y = row_ok && c < ck && k < g.K
                            ? prologue(g, v[i], u[i], ls[i], lb[i], mu[m],
                                       rstd[m])
                            : 0.0f;
        if (c < ck) xs[c * BM + m] = y;
        part += y;
      }
    }
    part = warp_sum(part);
    if (lane == 0) rs[m] += part;
  }
}

// Sum the K slices' partial products through shared memory (reusing the
// x chunk buffer) and apply the epilogue to COLS columns from n0.
template <int BM, int COLS>
__device__ void epilogue(const Args& g, int m0, int n0, int n_out,
                         const float (&acc)[BM][COLS / BN], float* red,
                         const float* rs) {
  constexpr int V = COLS / BN;
  const int ks = threadIdx.x / BN, cn = threadIdx.x % BN;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < V; ++j)
      red[(ks * BM + m) * COLS + cn * V + j] = acc[m][j];
  __syncthreads();
  for (int e = threadIdx.x; e < BM * COLS; e += THREADS) {
    const int m = e / COLS, c = e % COLS;
    const int gm = m0 + m, gn = n0 + c;
    if (gm >= g.M || gn >= n_out) continue;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < KSPLIT; ++k) s += red[(k * BM + m) * COLS + c];
    float y = (g.a * s + g.b * rs[m]) * g.scale[gn];
    if (g.bias) y += g.bias[gn];
    if (g.res) y += to_f(g.res[(size_t)gm * n_out + gn]);
    g.out[(size_t)gm * n_out + gn] = __float2bfloat16_rn(y);
  }
}

// Tile rules: PG word rows per tile, BK K rows per tile, TPC tiles per
// shared-memory chunk, WPT word rows per thread per chunk, row(i, ks) the
// chunk row of a thread's i-th word. 'pair' has HP planes per 16-bit half.
enum TileKind { TILE_PAIR = 0, TILE_PAIR3 = 1, TILE_PAIR3X = 2 };

template <int NB>
struct Pair {
  static constexpr int KIND = TILE_PAIR;
  static constexpr int NBITS = NB;
  static constexpr int HP = 16 / NB;
  static constexpr int PG = (HP % 2) ? 64 : 32;
  static constexpr int BK = 2 * PG * HP;
  static constexpr int TPC = BK >= 512 ? 1 : 512 / BK;
  static constexpr int CW = TPC * PG;   // word rows per chunk
  static constexpr int CK = TPC * BK;   // K rows per chunk
  static constexpr int WPT = CW / KSPLIT;
  static __device__ __forceinline__ int row(int i, int ks) {
    return ks + i * KSPLIT;
  }
};

// 'pair3': 24 word rows per 256-row tile, two tiles a chunk; per tile, low
// word ks and high word ks % 8.
struct Pair3 {
  static constexpr int KIND = TILE_PAIR3;
  static constexpr int NBITS = 3;
  static constexpr int PG = 24, BK = 256, TPC = 2;
  static constexpr int CW = TPC * PG, CK = TPC * BK, WPT = 4;
  static __device__ __forceinline__ int row(int i, int ks) {
    return (i / 2) * PG + (i % 2 ? 16 + (ks & 7) : ks);
  }
};

// 'pair3x': 56 word rows per 512-row group, one group a chunk; 4-bit words
// ks and ks + 16, low word 32 + ks, high word 48 + ks % 8.
struct Pair3x {
  static constexpr int KIND = TILE_PAIR3X;
  static constexpr int NBITS = 3;
  static constexpr int PG = 56, BK = 512, TPC = 1;
  static constexpr int CW = TPC * PG, CK = TPC * BK, WPT = 4;
  static __device__ __forceinline__ int row(int i, int ks) {
    return i == 0 ? ks : i == 1 ? ks + 16 : i == 2 ? 32 + ks : 48 + (ks & 7);
  }
};

// acc[m][v] += x rows (xl, xl + BM) times (lo, hi), the two K rows of a
// plane.
template <int BM, int NV>
__device__ __forceinline__ void fma_rows(float (&acc)[BM][NV], const float* xl,
                                         const float (&lo)[NV],
                                         const float (&hi)[NV]) {
#pragma unroll
  for (int m = 0; m < BM; m += 4) {
    const float4 a = *reinterpret_cast<const float4*>(xl + m);
    const float4 b = *reinterpret_cast<const float4*>(xl + BM + m);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        acc[m + e][v] += av[e] * lo[v] + bv[e] * hi[v];
  }
}

// A pair3x 4-bit word p whose rows 2p, 2p + 1 are at xt: plane j holds
// rows j*64 + 2p + h; the field ORs under exponent 129, 4 + idx/4.
template <int BM, int NV>
__device__ __forceinline__ void p4_word(float (&acc)[BM][NV],
                                        const uint32_t (&w)[NV],
                                        const float* xt) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = 3 - 4 * j;
    float lo[NV], hi[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      uint32_t u = s >= 0 ? (w[v] << s) : (w[v] >> (-s));
      u = (u & 0x00780078u) | 0x40804080u;
      lo[v] = __uint_as_float(u << 16) - 4.875f;
      hi[v] = __uint_as_float(u & 0xFFFF0000u) - 4.875f;
    }
    fma_rows<BM, NV>(acc, xt + j * 64 * BM, lo, hi);
  }
}

// Slice ks's rows of a pair3 tile whose row 0 is at xt: low word ks
// (plane j: rows j*32 + 2ks + h, 2 bits) and high word ks % 8, plane
// 2j + ks/8 (the same rows, 1 bit). The low field goes to mantissa bits
// 4-5 and the high bit to bit 6: C = 1 + idx/8.
template <int BM, int NV>
__device__ __forceinline__ void pair3_rows(float (&acc)[BM][NV],
                                           const uint32_t (&wl)[NV],
                                           const uint32_t (&wh)[NV],
                                           const float* xt, int ks) {
  uint32_t h[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) h[v] = wh[v] >> (ks >> 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int sl = 4 - 2 * j, sh = 6 - 2 * j;
    float lo[NV], hi[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const uint32_t a = sl >= 0 ? (wl[v] << sl) : (wl[v] >> (-sl));
      const uint32_t b = sh >= 0 ? (h[v] << sh) : (h[v] >> (-sh));
      const uint32_t u = (a & 0x00300030u) | (b & 0x00400040u) | 0x3F803F80u;
      lo[v] = (__uint_as_float(u << 16) - 1.4375f) * 2.0f;
      hi[v] = (__uint_as_float(u & 0xFFFF0000u) - 1.4375f) * 2.0f;
    }
    fma_rows<BM, NV>(acc, xt + (j * 32 + 2 * ks) * BM, lo, hi);
  }
}

// One chunk of a 3-bit layout: 32 K rows of slice ks (cw word rows; a
// pair3 chunk at the end of K may hold one tile only).
template <class P, int BM, int NV>
__device__ __forceinline__ void pair3_chunk(float (&acc)[BM][NV],
                                            const uint32_t (&w)[4][NV],
                                            const float* xs, int ks, int cw) {
  if constexpr (P::KIND == TILE_PAIR3X) {
    p4_word<BM, NV>(acc, w[0], xs + 2 * ks * BM);
    p4_word<BM, NV>(acc, w[1], xs + 2 * (ks + 16) * BM);
    pair3_rows<BM, NV>(acc, w[2], w[3], xs + 256 * BM, ks);
  } else {
    pair3_rows<BM, NV>(acc, w[0], w[1], xs, ks);
    if (cw > P::PG) pair3_rows<BM, NV>(acc, w[2], w[3], xs + P::BK * BM, ks);
  }
}

// Word rows kw0 + P::row(i, ks) (i < WPT) of NV columns from n; 0 past
// the matrix.
template <class P, int WPT, int NV>
__device__ __forceinline__ void load_words(uint32_t (&w)[WPT][NV],
                                           const int* words, int kw0, int kw,
                                           int N, int n, int ks) {
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const int row = kw0 + P::row(i, ks);
    const int* wp = words + (size_t)row * N + n;
    if (n < N && row < kw) {
      if constexpr (NV == 4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(wp));
        w[i][0] = q.x; w[i][1] = q.y; w[i][2] = q.z; w[i][3] = q.w;
      } else {
        w[i][0] = (uint32_t)__ldg(wp);
      }
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v) w[i][v] = 0u;
    }
  }
}

// NV consecutive columns per thread: 1 at decode (more blocks for the
// weight stream), 4 at prefill M (each x value loaded from shared memory
// feeds four columns; needs N % 4 == 0).
// Decode tiles (BM = 8) ask for two blocks per SM (at most 128 registers
// a thread); the prefill tiles need more registers than that.
template <class P, int BM, int NV>
__global__ void __launch_bounds__(THREADS, BM == 8 ? 2 : 1)
    pair_kernel(Args g) {
  constexpr int NB = P::NBITS;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  __shared__ float mu[BM], rstd[BM], rs[BM];
  const int ks = threadIdx.x / BN, cn = threadIdx.x % BN;
  const int n0 = blockIdx.x * BN * NV, m0 = blockIdx.y * BM;
  const int n = n0 + cn * NV;
  const int* words = static_cast<const int*>(g.w);
  if (threadIdx.x < BM) {
    mu[threadIdx.x] = 0.0f;
    rstd[threadIdx.x] = 0.0f;
    rs[threadIdx.x] = 0.0f;
  }
  __syncthreads();
  if (g.pre == PRE_LN || g.pre == PRE_RMS) row_stats<BM>(g, m0, mu, rstd);

  constexpr uint32_t mlow = ((1u << NB) - 1u) << (7 - NB);
  constexpr uint32_t mask = mlow | (mlow << 16);
  float acc[BM][NV];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[m][v] = 0.0f;

  constexpr int WPT = P::WPT;  // word rows per thread per chunk
  // The words of the next chunk are loaded while this one is built and
  // consumed (two register buffers), so their device-memory latency hides
  // behind the chunk's shared-memory work.
  uint32_t wn[WPT][NV];
  load_words<P, WPT, NV>(wn, words, 0, g.kw, g.N, n, ks);
  for (int kw0 = 0; kw0 < g.kw; kw0 += P::CW) {
    const int cw = min(P::CW, g.kw - kw0);
    uint32_t wb[WPT][NV];
#pragma unroll
    for (int i = 0; i < WPT; ++i)
#pragma unroll
      for (int v = 0; v < NV; ++v) wb[i][v] = wn[i][v];
    if (kw0 + P::CW < g.kw)
      load_words<P, WPT, NV>(wn, words, kw0 + P::CW, g.kw, g.N, n, ks);
    __syncthreads();  // the previous chunk is consumed
    fill_chunk<BM>(g, m0, kw0 / P::PG * P::BK, cw / P::PG * P::BK, xs, mu,
                   rstd, rs);
    __syncthreads();
    if (n >= g.N) continue;
    if constexpr (P::KIND != TILE_PAIR) {
      pair3_chunk<P, BM, NV>(acc, wb, xs, ks, cw);
    } else {
#pragma unroll
      for (int i = 0; i < WPT; ++i) {
        const int r = ks + i * KSPLIT;
        if (r >= cw) break;
        uint32_t w[NV];  // by value: a pointer would put wb in local memory
#pragma unroll
        for (int v = 0; v < NV; ++v) w[v] = wb[i][v];
        const int t = r / P::PG, p = r - t * P::PG;
        const float* xt = xs + (t * P::BK + 2 * p) * BM;
#pragma unroll
        for (int j = 0; j < P::HP; ++j) {
          const int s = 7 - NB - NB * j;  // shift of plane j into the mantissa
          float lo[NV], hi[NV];
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            uint32_t u = s >= 0 ? (w[v] << s) : (w[v] >> (-s));
            u = (u & mask) | 0x3F803F80u;
            // C - 1.5 of K rows 2p and 2p+1 (exact in f32)
            lo[v] = __uint_as_float(u << 16) - 1.5f;
            hi[v] = __uint_as_float(u & 0xFFFF0000u) - 1.5f;
          }
          const float* xl = xt + j * 2 * P::PG * BM;
#pragma unroll
          for (int m = 0; m < BM; m += 4) {
            const float4 a = *reinterpret_cast<const float4*>(xl + m);
            const float4 b = *reinterpret_cast<const float4*>(xl + BM + m);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int v = 0; v < NV; ++v)
                acc[m + e][v] += av[e] * lo[v] + bv[e] * hi[v];
          }
        }
      }
    }
  }
  epilogue<BM, BN * NV>(g, m0, n0, g.N, acc, xs, rs);
}

template <int BM>
__global__ void __launch_bounds__(THREADS, BM == 8 ? 2 : 1)
    int8_kernel(Args g) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  __shared__ float mu[BM], rstd[BM], rs[BM];
  const int ks = threadIdx.x / BN, cq = threadIdx.x % BN;
  const int n0 = blockIdx.x * BN * 4, m0 = blockIdx.y * BM;
  const int n = n0 + cq * 4;
  const int8_t* w8 = static_cast<const int8_t*>(g.w);
  if (threadIdx.x < BM) {
    mu[threadIdx.x] = 0.0f;
    rstd[threadIdx.x] = 0.0f;
    rs[threadIdx.x] = 0.0f;
  }
  __syncthreads();
  if (g.pre == PRE_LN || g.pre == PRE_RMS) row_stats<BM>(g, m0, mu, rstd);

  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;

  constexpr int RPT = CK8 / KSPLIT;  // weight rows per thread per chunk
  // Double-buffered in registers, as in pair_kernel.
  char4 wn[RPT];
  auto load_rows = [&](int k0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int k = k0 + ks + i * KSPLIT;
      wn[i] = n < g.ld_w && k < g.K
                  ? __ldg(reinterpret_cast<const char4*>(
                        w8 + (size_t)k * g.ld_w + n))
                  : make_char4(0, 0, 0, 0);
    }
  };
  load_rows(0);
  for (int k0 = 0; k0 < g.K; k0 += CK8) {
    const int ck = min(CK8, g.K - k0);
    char4 wb[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) wb[i] = wn[i];
    if (k0 + CK8 < g.K) load_rows(k0 + CK8);
    __syncthreads();
    fill_chunk<BM>(g, m0, k0, ck, xs, mu, rstd, rs);
    __syncthreads();
    if (n >= g.ld_w) continue;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ks + i * KSPLIT;
      if (r >= ck) break;
      const char4 v = wb[i];
      const float v0 = v.x, v1 = v.y, v2 = v.z, v3 = v.w;
      const float* xr = xs + r * BM;
#pragma unroll
      for (int m = 0; m < BM; m += 4) {
        const float4 a = *reinterpret_cast<const float4*>(xr + m);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[m + e][0] += av[e] * v0;
          acc[m + e][1] += av[e] * v1;
          acc[m + e][2] += av[e] * v2;
          acc[m + e][3] += av[e] * v3;
        }
      }
    }
  }
  epilogue<BM, BN * 4>(g, m0, n0, g.N, acc, xs, rs);
}

template <class P, int BM, int NV>
int launch_pair(const Args& g, cudaStream_t stream) {
  constexpr int red = KSPLIT * BM * BN * NV;
  const int bytes = 4 * (P::CK * BM > red ? P::CK * BM : red);
  static bool raised = false;
  cudaError_t err = allow_smem(pair_kernel<P, BM, NV>, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.N + BN * NV - 1) / (BN * NV), (g.M + BM - 1) / BM);
  pair_kernel<P, BM, NV><<<grid, THREADS, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

template <class P>
int launch_pair_m(const Args& g, cudaStream_t stream) {
  if (g.M <= 8) return launch_pair<P, 8, 1>(g, stream);
  if (g.N % 4 == 0) return launch_pair<P, 16, 4>(g, stream);
  return launch_pair<P, 16, 1>(g, stream);
}

template <class P>
int pair3_entry(const void* x, const void* words, const void* scale,
                const void* bias, const void* ln_s, const void* ln_b,
                int ln_bf16, const void* res, void* out, int M, int N, int K,
                int x_cols, int kw, int pre, float a, float b, float eps,
                void* stream) {
  Args g{static_cast<const bf16*>(x), words,
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         ln_s, ln_b, ln_bf16, static_cast<const bf16*>(res),
         static_cast<bf16*>(out), M, N, K, x_cols, kw, N, pre, a, b, eps};
  return launch_pair_m<P>(g, static_cast<cudaStream_t>(stream));
}

template <int BM>
int launch_int8(const Args& g, cudaStream_t stream) {
  const int bytes = 4 * (CK8 * BM > KSPLIT * BM * BN * 4
                             ? CK8 * BM : KSPLIT * BM * BN * 4);
  static bool raised = false;
  cudaError_t err = allow_smem(int8_kernel<BM>, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.N + BN * 4 - 1) / (BN * 4), (g.M + BM - 1) / BM);
  int8_kernel<BM><<<grid, THREADS, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. x (M, x_cols) bf16 (x_cols = K, or 2K for silu_glu); words (kw, N)
// int32 'pair'; scale/bias (N,) f32 (bias may be null); ln_s/ln_b (K,)
// f32 or bf16 (ln_bf16); res (M, N) bf16 or null; out (M, N) bf16. The
// product runs over the centred weight C - 1.5, so b must be the rowsum
// coefficient of that fold: b_aff + 1.5 * a_aff.
extern "C" int pair_matmul(const void* x, const void* words,
                           const void* scale, const void* bias,
                           const void* ln_s, const void* ln_b, int ln_bf16,
                           const void* res, void* out, int M, int N, int K,
                           int x_cols, int kw, int nbits, int pre, float a,
                           float b, float eps, void* stream) {
  Args g{static_cast<const bf16*>(x), words,
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         ln_s, ln_b, ln_bf16, static_cast<const bf16*>(res),
         static_cast<bf16*>(out), M, N, K, x_cols, kw, N, pre, a, b, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return launch_pair_m<Pair<1>>(g, s);
    case 2: return launch_pair_m<Pair<2>>(g, s);
    case 3: return launch_pair_m<Pair<3>>(g, s);
    case 4: return launch_pair_m<Pair<4>>(g, s);
    case 5: return launch_pair_m<Pair<5>>(g, s);
    case 6: return launch_pair_m<Pair<6>>(g, s);
    case 7: return launch_pair_m<Pair<7>>(g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6 ('pair3x', K % 512 == 0) and K7 ('pair3'): arguments as K1 without
// nbits; a = 4*step and b = zero + 3.5*step, the rowsum coefficient of the
// centred weight idx/4 - 0.875.
extern "C" int pair3x_matmul(const void* x, const void* words,
                             const void* scale, const void* bias,
                             const void* ln_s, const void* ln_b, int ln_bf16,
                             const void* res, void* out, int M, int N, int K,
                             int x_cols, int kw, int pre, float a, float b,
                             float eps, void* stream) {
  return pair3_entry<Pair3x>(x, words, scale, bias, ln_s, ln_b, ln_bf16, res,
                             out, M, N, K, x_cols, kw, pre, a, b, eps,
                             stream);
}

extern "C" int pair3_matmul(const void* x, const void* words,
                            const void* scale, const void* bias,
                            const void* ln_s, const void* ln_b, int ln_bf16,
                            const void* res, void* out, int M, int N, int K,
                            int x_cols, int kw, int pre, float a, float b,
                            float eps, void* stream) {
  return pair3_entry<Pair3>(x, words, scale, bias, ln_s, ln_b, ln_bf16, res,
                            out, M, N, K, x_cols, kw, pre, a, b, eps, stream);
}

// K2. x (M, K) bf16; w8 (Kp, Np) int8, Kp >= K, Np % 4 == 0; out (M, N)
// bf16 with N <= Np (the padded vocab columns are never written); other
// arguments as K1.
extern "C" int int8_matmul(const void* x, const void* w8, const void* scale,
                           const void* bias, const void* ln_s,
                           const void* ln_b, int ln_bf16, const void* res,
                           void* out, int M, int N, int K, int Kp, int Np,
                           int pre, float a, float b, float eps,
                           void* stream) {
  (void)Kp;
  Args g{static_cast<const bf16*>(x), w8, static_cast<const float*>(scale),
         static_cast<const float*>(bias), ln_s, ln_b, ln_bf16,
         static_cast<const bf16*>(res), static_cast<bf16*>(out), M, N, K, K,
         0, Np, pre, a, b, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return g.M <= 8 ? launch_int8<8>(g, s) : launch_int8<16>(g, s);
}
