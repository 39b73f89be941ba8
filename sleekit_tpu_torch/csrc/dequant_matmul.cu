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
// What bounds it on an H100: at decode (M <= 8) the packed weight stream
// (K*N*nbits/8 bytes; 8 MB for OPT-1.3B fc1) over device memory, a few
// microseconds per projection; at prefill M (M > 8) the products, 2*M*K*N
// operations (26 GFLOP for OPT-1.3B qkv at M = 1024, 26 us at the bf16
// tensor-core rate), which CUDA-core FMAs run some 15x slower than that.
//
// Two routes per kernel, one launch entry. K1, K6, K7: M <= 8 runs
// pair_kernel<P, 8, 1> (below).
// M > 8 runs two kernels on the same stream: prologue_kernel writes pre(x)
// once per call, as bf16 into the scratch xp (M, K rounded up to 64, 0
// past K) with its row sums in rs, and pair_mma_kernel multiplies it on
// the tensor cores (mma.sync m16n8k16 bf16, f32 accumulation). A pair
// word holds K rows 2p and 2p+1 of one column as two bf16 mantissas, the
// layout of one .b32 register of an m16n8k16 B fragment, so B is built in
// registers straight from the words (shift, mask, OR the exponent, one
// exact bf16x2 FMA to centre it) and no dequantized tile exists in shared
// memory. A and the words arrive by cp.async in a ring of three 64-row
// stages; A fragments come from shared memory by ldmatrix.
//
// The decode route: every weight word is read once per
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
// Each decode block owns 16 columns and one M tile of 8 rows; its 256
// threads split K 16 ways and sum the slices through shared memory at the
// end. pre(x) of the block's
// rows is built chunk by chunk in shared memory, row-minor, so one 16-byte
// load serves four rows. The decode route is the simple first version:
// CUDA-core FMAs, no split-K across blocks (N = 2048 projections fill 128
// of 132 SMs), and every block recomputes its rows' norm statistics.
// The tensor-core route uses mma.sync, not wgmma, and cp.async, not TMA.
//
// K2 (the int8 head, OPT-1.3B: 2048 x 51200 bytes, 106 MB) runs the
// prologue pass at every M, so norm statistics and pre(x) are built once
// per call, then one of two kernels:
// - M > 8, int8_mma_kernel: bound by its products (2*M*K*N, 0.21 ms at
//   M = 1024 at the bf16 tensor-core rate; at M = 64 by the 106 MB, 0.033
//   ms). pair_mma_kernel's pipeline and epilogue, but an int8 value takes
//   8 significant bits, one more than a bf16 mantissa stores, so no
//   exponent OR decodes it, and the two K rows of a B register lie Np
//   bytes apart. The raw bytes arrive by 16-byte loads into registers,
//   two 64-row chunks ahead, and each chunk is converted once (byte into
//   the low mantissa of 2^23, one f32 subtraction, the upper half is the
//   exact bf16) into a bf16 K x N tile in shared memory, whose B
//   fragments come by ldmatrix.trans; A comes by cp.async as in K1.
//   128 x 128 tiles (64 x 128 at M <= 64), M tiles along the grid's x so
//   the M tiles of a column strip share its bytes through L2.
// - M <= 8, int8_stream_kernel: bound by the 106 MB weight stream (0.032
//   ms at 3.35 TB/s). The weight is the m16n8k16 A operand and the tokens
//   the n8, so the products cost a few instructions per 16 bytes and the
//   loads are 16 bytes a lane along N, the next k16 step's in flight in
//   registers while this one's products run. K is split across a block's
//   8 warps, whose sums meet in a fixed order.
#include "common.cuh"

namespace {

enum Pre { PRE_NONE = 0, PRE_LN = 1, PRE_RMS = 2, PRE_RELU = 3, PRE_GELU = 4,
           PRE_GLU = 5 };

constexpr int THREADS = 256;
constexpr int KSPLIT = 16;   // K slices (threads along K) per block
constexpr int BN = 16;       // threads along N per block
constexpr int NWARPS = THREADS / 32;

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
  bf16* xp;   // tensor-core route scratch: pre(x), (M, xp_cols(K))
  float* rs;  // and its row sums, (M,)
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

// Word rows kw0 + P::row(i, ks) (i < WPT) of column n; 0 past the matrix.
template <class P, int WPT, int NV>
__device__ __forceinline__ void load_words(uint32_t (&w)[WPT][NV],
                                           const int* words, int kw0, int kw,
                                           int N, int n, int ks) {
  static_assert(NV == 1, "the decode tiles take one column per thread");
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const int row = kw0 + P::row(i, ks);
    const int* wp = words + (size_t)row * N + n;
    if (n < N && row < kw) {
      w[i][0] = (uint32_t)__ldg(wp);
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v) w[i][v] = 0u;
    }
  }
}

// The decode route (M <= 8): BM = 8 rows, NV = 1 column per thread (more
// blocks for the weight stream), two blocks per SM (at most 128 registers
// a thread).
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

// ---- the tensor-core route (M > 8) -----------------------------------------

constexpr int MMA_KC = 64;      // K rows per pipeline stage
constexpr int MMA_KW = 32;      // word rows per stage, at most
constexpr int MMA_STAGES = 3;

// Columns of the scratch xp: K rounded up to whole stages.
__device__ __forceinline__ int xp_cols(int K) {
  return (K + MMA_KC - 1) / MMA_KC * MMA_KC;
}

// W consecutive bf16 values from p (W = 8: one 16-byte load) as f32.
template <int W>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&v)[W]) {
  if constexpr (W == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  } else {
    v[0] = to_f(p[0]);
  }
}

// W consecutive values of an f32 or bf16 parameter vector from k.
template <int W>
__device__ __forceinline__ void load_params(const void* p, int k, int is_bf16,
                                            float (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = load_param(p, k, is_bf16);
  } else if (is_bf16) {
    load_bf16<W>(static_cast<const bf16*>(p) + k, v);
  } else {
    const float4* f = reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + k);
    const float4 a = __ldg(f), b = __ldg(f + 1);
    const float t[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = t[e];
  }
}

// pre(x) once per call: block m writes row m of g.xp as bf16 (0 past K)
// and the row's sum into g.rs, W consecutive columns a thread at a time
// (W = 8: 16-byte loads and stores, for K % 8 == 0 and aligned rows; else
// W = 1), so every load of a row is in flight at once. The norm
// statistics run over the valid K in two passes, as row_stats does.
template <int W>
__global__ void __launch_bounds__(THREADS) prologue_kernel(Args g) {
  __shared__ float red[NWARPS];
  const int tid = threadIdx.x, m = blockIdx.x;
  const auto block_sum = [&](float v) {
    v = warp_sum(v);
    __syncthreads();  // red's previous sum has been read
    if (tid % 32 == 0) red[tid / 32] = v;
    __syncthreads();
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) t += red[w];
    return t;
  };
  const bool glu = g.pre == PRE_GLU;
  const bool norm = g.pre == PRE_LN || g.pre == PRE_RMS;
  const bf16* row = g.x + (size_t)m * g.x_cols;
  float mu = 0.0f, rstd = 0.0f;
  for (int pass = g.pre == PRE_LN ? 0 : 1; norm && pass < 2; ++pass) {
    float s = 0.0f;
#pragma unroll 4
    for (int k = W * tid; k < g.K; k += W * THREADS) {
      float v[W];
      load_bf16<W>(row + k, v);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float d = v[e] - mu;
        s += pass == 0 ? v[e] : d * d;
      }
    }
    s = block_sum(s);
    if (pass == 0) mu = s / (float)g.K;
    else rstd = 1.0f / sqrtf(s / (float)g.K + g.eps);
  }
  const int kp = xp_cols(g.K);
  bf16* dst = g.xp + (size_t)m * kp;
  float part = 0.0f;
#pragma unroll 4
  for (int k = W * tid; k < kp; k += W * THREADS) {
    float v[W], u[W], ls[W], lb[W], y[W];
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = u[e] = ls[e] = lb[e] = 0.0f;
    if (k < g.K) {
      load_bf16<W>(row + k, v);
      if (glu) load_bf16<W>(row + g.K + k, u);
      if (norm) load_params<W>(g.ln_s, k, g.ln_bf16, ls);
      if (norm && g.ln_b) load_params<W>(g.ln_b, k, g.ln_bf16, lb);
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      // exact in bf16: prologue() rounds, or x is bf16 already
      y[e] = k + e < g.K ? prologue(g, v[e], u[e], ls[e], lb[e], mu, rstd)
                         : 0.0f;
      part += y[e];
    }
    if constexpr (W == 8) {
      uint32_t q[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        __nv_bfloat162 b2 = __floats2bfloat162_rn(y[2 * h], y[2 * h + 1]);
        q[h] = *reinterpret_cast<uint32_t*>(&b2);
      }
      *reinterpret_cast<uint4*>(dst + k) = make_uint4(q[0], q[1], q[2], q[3]);
    } else {
      dst[k] = __float2bfloat16_rn(y[0]);
    }
  }
  part = block_sum(part);
  if (tid == 0) g.rs[m] = part;
}

// 4 bytes from global to shared memory, asynchronously; zeros when !ok.
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// u's two bf16 halves times m plus c, as bf16x2 (exact for every use
// here: the results are multiples of 2^-7 within +-7/8).
__device__ __forceinline__ uint32_t bf2_fma(uint32_t u, float m, float c) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  v = __hfma2(v, __float2bfloat162_rn(m), __float2bfloat162_rn(c));
  return *reinterpret_cast<uint32_t*>(&v);
}

// A pair3 B register: low word wl, plane j (2-bit fields) and high word
// wh, plane i (1 bit), OR'd into the mantissa as C = 1 + idx/8, then
// 2*(C - 1.4375) = idx/4 - 0.875.
__device__ __forceinline__ uint32_t pair3_b(uint32_t wl, uint32_t wh, int j,
                                            int i) {
  const uint32_t u = (((wl >> (2 * j)) << 4) & 0x00300030u) |
                     (((wh >> i) << 6) & 0x00400040u) | 0x3F803F80u;
  return bf2_fma(u, 2.0f, -2.875f);
}

// Step S (0..15) of a pair3 tile: low plane S/2, word rows (S%2)*8 + t4
// and + 4; high words 16 + t4 and 20 + t4 (their index p % 8), plane S.
__device__ __forceinline__ void pair3_frag(const int* ws, int ld, int S,
                                           int t4, uint32_t (&b)[2]) {
  const int lo = (S & 1) * 8 + t4;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    b[h] = pair3_b((uint32_t)ws[(lo + 4 * h) * ld],
                   (uint32_t)ws[(16 + t4 + 4 * h) * ld], S >> 1, S);
}

// The word rows of 64-row chunk c (K rows 64c .. 64c + 63) under tile rule
// P: (first, count), count <= MMA_KW. 'pair': a plane spans 2*PG K rows,
// word row p holding rows 2p, 2p+1, so a chunk reads 32 word rows of its
// tile (all of them when PG = 32, one half when PG = 64); 'pair3': all 24
// words of its 256-row tile; 'pair3x': the 32 4-bit words or the 24 pair3
// words of its 512-row group.
template <class P>
__device__ __forceinline__ int2 chunk_words(int c) {
  if constexpr (P::KIND == TILE_PAIR) {
    constexpr int CPT = P::BK / MMA_KC, HALVES = P::PG / 32;
    return make_int2(c / CPT * P::PG + (c % CPT % HALVES) * 32, 32);
  } else if constexpr (P::KIND == TILE_PAIR3) {
    return make_int2((c >> 2) * P::PG, 24);
  } else {
    const bool p4 = (c & 7) < 4;
    return make_int2((c >> 3) * P::PG + (p4 ? 0 : 32), p4 ? 32 : 24);
  }
}

// Lane (g = l/4, t4 = l%4)'s B registers of k16 step s of chunk c, for the
// column whose chunk words are ws[r * ld] (r from chunk_words' first):
// register h holds K rows 8h + 2*t4 and + 1 of the step, the lower row in
// the low half, which is one word's plane. PART selects a 'pair3x'
// chunk's kind (0: its 4-bit fields, chunks c % 8 < 4; 1: its pair3 tile)
// at compile time.
template <class P, int PART>
__device__ __forceinline__ void b_frag(const int* ws, int ld, int c, int s,
                                       int t4, uint32_t (&b)[2]) {
  if constexpr (P::KIND == TILE_PAIR) {
    constexpr int NB = P::NBITS, HALVES = P::PG / 32;
    constexpr uint32_t mlow = ((1u << NB) - 1u) << (7 - NB);
    const int j = c % (P::BK / MMA_KC) / HALVES;  // the chunk's plane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w = (uint32_t)ws[(8 * s + 4 * h + t4) * ld];
      const uint32_t u = (((w >> (NB * j)) << (7 - NB)) & (mlow | mlow << 16))
                         | 0x3F803F80u;
      b[h] = bf2_fma(u, 1.0f, -1.5f);  // C - 1.5
    }
  } else if constexpr (P::KIND == TILE_PAIR3) {
    pair3_frag(ws, ld, 4 * (c & 3) + s, t4, b);
  } else if constexpr (PART == 0) {  // 4-bit fields, plane c % 8 (< 4)
    const int j = c & 7;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w = (uint32_t)ws[(8 * s + 4 * h + t4) * ld];
      const uint32_t u = (((w >> (4 * j)) << 3) & 0x00780078u) | 0x40804080u;
      b[h] = bf2_fma(u, 1.0f, -4.875f);  // 4 + idx/4 - 4.875
    }
  } else {
    pair3_frag(ws, ld, 4 * ((c & 7) - 4) + s, t4, b);
  }
}

// A block of 8 warps, 2 along M and 4 along N, each warp WM m16 tiles by
// WN n8 tiles. Shared rows are padded by 16 bytes so that ldmatrix's eight
// rows and the four word rows of a B load fall on distinct banks.
template <int WM, int WN>
struct MmaTile {
  static constexpr int BM = 2 * 16 * WM, BN = 4 * 8 * WN;
  static constexpr int A_LD = MMA_KC + 8;  // bf16 per A row
  static constexpr int W_LD = BN + 8;      // int32 per word row
  static constexpr int A_BYTES = BM * A_LD * 2;
  static constexpr int STAGE = A_BYTES + MMA_KW * W_LD * 4;
  static constexpr int SMEM = MMA_STAGES * STAGE;
};

// The products of one 64-row chunk: sa at the warp's first A row (lane's
// ldmatrix address), ws at its first column (lane's B column). SERIAL
// keeps the k16 steps a loop, so their word loads are not all hoisted.
template <class P, int PART, int WM, int WN, bool SERIAL>
__device__ __forceinline__ void mma_chunk(float (&acc)[WM][WN][4],
                                          const bf16* sa, const int* ws,
                                          int c, int t4) {
  using T = MmaTile<WM, WN>;
#pragma unroll (SERIAL ? 1 : MMA_KC / 16)
  for (int s = 0; s < MMA_KC / 16; ++s) {
    uint32_t a[WM][4];
#pragma unroll
    for (int i = 0; i < WM; ++i) ldsm_x4(a[i], sa + i * 16 * T::A_LD + 16 * s);
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      uint32_t b[2];
      b_frag<P, PART>(ws + 8 * j, T::W_LD, c, s, t4, b);
#pragma unroll
      for (int i = 0; i < WM; ++i) mma_bf16(acc[i][j], a[i], b);
    }
  }
}

// The epilogue from the fragments of a warp's WM x WN tiles, whose first
// row is mb and first column nb: lane (g, t4) holds rows g and g + 8 of
// each m16 tile, columns 2*t4 and 2*t4 + 1 of each n8 tile. The output
// (and the residual) is g.N columns wide.
template <int WM, int WN>
__device__ __forceinline__ void mma_epilogue(const Args& g,
                                             const float (&acc)[WM][WN][4],
                                             int mb, int nb, int lane) {
  const int t4 = lane % 4;
  const bool pairs = g.N % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(g.out) & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(g.res) & 3) == 0;
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mb + i * 16 + lane / 4 + 8 * h;
      if (m >= g.M) continue;
      const float brs = g.b * g.rs[m];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int n = nb + 8 * j + 2 * t4;
        if (n >= g.N) continue;
        const size_t o = (size_t)m * g.N + n;
        float y0 = (g.a * acc[i][j][2 * h] + brs) * g.scale[n];
        if (g.bias) y0 += g.bias[n];
        if (n + 1 < g.N) {
          float y1 = (g.a * acc[i][j][2 * h + 1] + brs) * g.scale[n + 1];
          if (g.bias) y1 += g.bias[n + 1];
          if (pairs) {
            if (g.res) {
              const float2 r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(g.res + o));
              y0 += r.x;
              y1 += r.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(g.out + o) =
                __floats2bfloat162_rn(y0, y1);
            continue;
          }
          if (g.res) y1 += to_f(g.res[o + 1]);
          g.out[o + 1] = __float2bfloat16_rn(y1);
        }
        if (g.res) y0 += to_f(g.res[o]);
        g.out[o] = __float2bfloat16_rn(y0);
      }
    }
}

// out[m0 .. m0+BM, n0 .. n0+BN] of the tensor-core route: the 64-row chunks
// of xp and their word rows stream through a ring of MMA_STAGES stages.
// MINB blocks per SM (2 caps the registers at 128 a thread).
template <class P, int WM, int WN, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) pair_mma_kernel(Args g) {
  using T = MmaTile<WM, WN>;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4, t4 = lane % 4;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int kp = xp_cols(g.K), chunks = kp / MMA_KC;
  const int* words = static_cast<const int*>(g.w);
  // 16-byte word copies need 16-byte aligned rows.
  const bool vec = g.N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;

  auto load = [&](int c, int st) {
    bf16* sa = reinterpret_cast<bf16*>(smem + st * T::STAGE);
    int* sw = reinterpret_cast<int*>(smem + st * T::STAGE + T::A_BYTES);
    for (int i = tid; i < T::BM * (MMA_KC / 8); i += THREADS) {
      const int r = i / (MMA_KC / 8), q = i % (MMA_KC / 8);
      const int m = min(m0 + r, g.M - 1);  // rows past M: never stored
      cp16(sa + r * T::A_LD + 8 * q,
           g.xp + (size_t)m * kp + c * MMA_KC + 8 * q, true);
    }
    const int2 cw = chunk_words<P>(c);
    if (vec) {
      for (int i = tid; i < cw.y * (T::BN / 4); i += THREADS) {
        const int r = i / (T::BN / 4), n = 4 * (i % (T::BN / 4));
        const bool ok = n0 + n < g.N && cw.x + r < g.kw;
        cp16(sw + r * T::W_LD + n,
             ok ? words + (size_t)(cw.x + r) * g.N + n0 + n : words, ok);
      }
    } else {
      for (int i = tid; i < cw.y * T::BN; i += THREADS) {
        const int r = i / T::BN, n = i % T::BN;
        const bool ok = n0 + n < g.N && cw.x + r < g.kw;
        cp4(sw + r * T::W_LD + n,
            ok ? words + (size_t)(cw.x + r) * g.N + n0 + n : words, ok);
      }
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < MMA_STAGES - 1; ++st) {
    if (st < chunks) load(st, st);
    cp_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_wait<MMA_STAGES - 2>();  // chunk c has arrived
    __syncthreads();            // ... for every thread; chunk c-1 is consumed
    if (c + MMA_STAGES - 1 < chunks)
      load(c + MMA_STAGES - 1, (c + MMA_STAGES - 1) % MMA_STAGES);
    cp_commit();
    const int st = c % MMA_STAGES;
    const bf16* sa = reinterpret_cast<const bf16*>(smem + st * T::STAGE) +
                     (wm * 16 * WM + lane % 16) * T::A_LD + 8 * (lane / 16);
    const int* ws = reinterpret_cast<const int*>(smem + st * T::STAGE +
                                                 T::A_BYTES) +
                    wn * 8 * WN + lane / 4;
    // At two blocks an SM the pair3 decode's hoisted words would spill
    // past 128 registers: its steps stay a loop there (measured as fast).
    constexpr bool p3_serial = MINB == 2;
    if (P::KIND == TILE_PAIR3X && (c & 7) >= 4)
      mma_chunk<P, 1, WM, WN, p3_serial>(acc, sa, ws, c, t4);
    else
      mma_chunk<P, 0, WM, WN, p3_serial && P::KIND == TILE_PAIR3>(acc, sa,
                                                                 ws, c, t4);
  }

  mma_epilogue<WM, WN>(g, acc, m0 + wm * 16 * WM, n0 + wn * 8 * WN, lane);
}

template <class P, int WM, int WN, int MINB>
int launch_mma(const Args& g, cudaStream_t stream) {
  using T = MmaTile<WM, WN>;
  static bool raised = false;
  cudaError_t err =
      allow_smem(pair_mma_kernel<P, WM, WN, MINB>, T::SMEM, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.N + T::BN - 1) / T::BN, (g.M + T::BM - 1) / T::BM);
  pair_mma_kernel<P, WM, WN, MINB><<<grid, THREADS, T::SMEM, stream>>>(g);
  return (int)cudaGetLastError();
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

// The prologue pass: 16-byte loads and stores where K % 8 == 0 and the
// rows and norm parameters are aligned, else one column a thread.
int launch_prologue(const Args& g, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool norm = g.pre == PRE_LN || g.pre == PRE_RMS;
  if (g.K % 8 == 0 && aligned(g.x) &&
      (!norm || (aligned(g.ln_s) && aligned(g.ln_b))))
    prologue_kernel<8><<<g.M, THREADS, 0, stream>>>(g);
  else
    prologue_kernel<1><<<g.M, THREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// M <= 8: the decode kernel. M > 8: the prologue pass, then the tensor-core
// kernel in 128 x 128 tiles, two blocks an SM where they fill the card
// twice over (264 blocks; fewer registers, more warps), else one; or in
// 32 x 64 tiles where the large ones would leave more than half the SMs
// idle (fewer than 64 blocks). Measured on OPT-1.3B's projections (PERF.md).
template <class P>
int launch_pair_m(const Args& g, cudaStream_t stream) {
  if (g.M <= 8) return launch_pair<P, 8, 1>(g, stream);
  if (!g.xp || !g.rs) return (int)cudaErrorInvalidValue;
  const int err = launch_prologue(g, stream);
  if (err != cudaSuccess) return err;
  using Wide = MmaTile<4, 4>;
  const int wide = ((g.M + Wide::BM - 1) / Wide::BM) *
                   ((g.N + Wide::BN - 1) / Wide::BN);
  if (wide >= 264) return launch_mma<P, 4, 4, 2>(g, stream);
  if (wide >= 64) return launch_mma<P, 4, 4, 1>(g, stream);
  return launch_mma<P, 1, 2, 1>(g, stream);
}

template <class P>
int pair3_entry(const void* x, const void* words, const void* scale,
                const void* bias, const void* ln_s, const void* ln_b,
                int ln_bf16, const void* res, void* out, void* xp, void* rs,
                int M, int N, int K, int x_cols, int kw, int pre, float a,
                float b, float eps, void* stream) {
  Args g{static_cast<const bf16*>(x), words,
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         ln_s, ln_b, ln_bf16, static_cast<const bf16*>(res),
         static_cast<bf16*>(out), M, N, K, x_cols, kw, N, pre, a, b, eps,
         static_cast<bf16*>(xp), static_cast<float*>(rs)};
  return launch_pair_m<P>(g, static_cast<cudaStream_t>(stream));
}

// ---- K2: the int8 head --------------------------------------------------

// Four signed bytes as bf16 (exact: |v| <= 128 has at most 8 significant
// bits): byte j + 128 goes into the low mantissa of 2^23, so the f32
// 2^23 + 128 + v less 2^23 + 128 is v; its upper half is v in bf16. Returns
// (bytes 0, 1) and (bytes 2, 3), the lower byte in the low half.
__device__ __forceinline__ uint2 s8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)) -
        8388736.0f);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

// 16 weight bytes of K row k from column n: zeros at or past Kp or Np; one
// byte at a time unless vec.
__device__ __forceinline__ uint4 load_w16(const Args& g, const int8_t* w8,
                                          int k, int n, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (k >= g.kw) return v;
  const int8_t* p = w8 + (size_t)k * g.ld_w + n;
  if (vec) return n < g.ld_w ? __ldg(reinterpret_cast<const uint4*>(p)) : v;
  uint32_t q[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; b < 16; ++b)
    if (n + b < g.ld_w) q[b / 4] |= (uint32_t)(uint8_t)p[b] << (8 * (b % 4));
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// The prefill route's tiles: 8 warps, 2 along M and 4 along N, each WM m16
// by WN n8 tiles (WN even), with a ring of ST stages of 64 rows of A (bf16,
// as in MmaTile). The weight's 64 K rows of BN columns arrive by plain
// 16-byte loads into registers, WL a thread, two chunks ahead, and are
// converted once into one bf16 copy, Bs (rows padded by 16 bytes so that
// ldmatrix's eight rows fall on distinct banks), which feeds the products.
template <int WM, int WN, int ST>
struct Int8Tile {
  static constexpr int BM = 2 * 16 * WM, BN = 4 * 8 * WN;
  static constexpr int A_LD = MMA_KC + 8;  // bf16 per A row
  static constexpr int B_LD = BN + 8;      // bf16 per Bs row
  static constexpr int STAGE = BM * A_LD * 2;
  static constexpr int SMEM = ST * STAGE + MMA_KC * B_LD * 2;
  static constexpr int WL = MMA_KC * BN / 16 / THREADS;
};

// 16 raw bytes (columns n .. n + 15 of one row) as bf16 into dst: two
// 16-byte stores, in the order swap gives.
__device__ __forceinline__ void store_bf16x16(bf16* dst, uint4 q, bool swap) {
  const uint2 a = s8x4_bf16(q.x), b = s8x4_bf16(q.y);
  const uint2 c = s8x4_bf16(q.z), d = s8x4_bf16(q.w);
  const uint4 lo = make_uint4(a.x, a.y, b.x, b.y);
  const uint4 hi = make_uint4(c.x, c.y, d.x, d.y);
  uint4* p = reinterpret_cast<uint4*>(dst);
  if (swap) {
    p[1] = hi;
    p[0] = lo;
  } else {
    p[0] = lo;
    p[1] = hi;
  }
}

// out[m0 .. m0+BM, n0 .. n0+BN] of K2 at M > 8: the 64-row chunks of xp
// stream through a ring of ST stages by cp.async (rows past M skipped);
// the weight's raw rows (at or past Kp, which are not allocated, zeros)
// are loaded into registers two chunks ahead and converted into Bs,
// whose B fragments come by ldmatrix.trans. Two barriers a chunk: Bs is
// single-buffered.
template <int WM, int WN, int MINB, int ST>
__global__ void __launch_bounds__(THREADS, MINB) int8_mma_kernel(Args g) {
  using T = Int8Tile<WM, WN, ST>;
  static_assert(WN % 2 == 0, "ldmatrix.x4.trans serves two n8 tiles");
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  bf16* bs = reinterpret_cast<bf16*>(smem + ST * T::STAGE);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  // M tiles along x: the tiles of one column strip run together and
  // share its weight bytes through L2.
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * T::BN;
  const int kp = xp_cols(g.K), chunks = kp / MMA_KC;
  const int8_t* w8 = static_cast<const int8_t*>(g.w);
  // 16-byte copies need 16-byte aligned rows; else one byte at a time.
  const bool vec = g.ld_w % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(w8) & 15) == 0;

  auto load = [&](int c, int st) {
    bf16* sa = reinterpret_cast<bf16*>(smem + st * T::STAGE);
    for (int i = tid; i < T::BM * (MMA_KC / 8); i += THREADS) {
      const int r = i / (MMA_KC / 8), q = i % (MMA_KC / 8);
      // Rows past M feed only output rows that are never stored: not
      // copied (the zero-filling form of cp.async is slower).
      if (m0 + r < g.M)
        cp16(sa + r * T::A_LD + 8 * q,
             g.xp + (size_t)(m0 + r) * kp + c * MMA_KC + 8 * q, true);
    }
  };
  // Thread tid holds the 16-byte pieces tid + i * THREADS of a chunk, row
  // e / (BN/16), columns 16 * (e % (BN/16)); with 8 pieces a row, the
  // second 8-byte half goes first in every other group of four threads,
  // so a quarter-warp's stores fall on distinct banks.
  auto ldw = [&](int c, uint4 (&q)[T::WL]) {
#pragma unroll
    for (int i = 0; i < T::WL; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (T::BN / 16), n = 16 * (e % (T::BN / 16));
      q[i] = c < chunks ? load_w16(g, w8, c * MMA_KC + r, n0 + n, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stw = [&](const uint4 (&q)[T::WL]) {
#pragma unroll
    for (int i = 0; i < T::WL; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (T::BN / 16), n = 16 * (e % (T::BN / 16));
      store_bf16x16(bs + r * T::B_LD + n, q[i],
                    T::BN >= 128 && ((e >> 2) & 1));
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  uint4 rw[2][T::WL];
  ldw(0, rw[0]);
  ldw(1, rw[1]);
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (st < chunks) load(st, st);
    cp_commit();
  }
  // Lane addresses: A as in pair_mma_kernel; Bs rows lane % 16 of a k16
  // step, columns 8 * (lane / 16) of an n8 pair.
  const bf16* sb = bs + (lane % 16) * T::B_LD + wn * 8 * WN + 8 * (lane / 16);
  auto chunk = [&](int c, uint4 (&q)[T::WL]) {
    cp_wait<ST - 2>();  // chunk c has arrived
    __syncthreads();    // ... for every thread; chunk c-1 is consumed
    if (c + ST - 1 < chunks) load(c + ST - 1, (c + ST - 1) % ST);
    cp_commit();
    const int st = c % ST;
    stw(q);
    ldw(c + 2, q);
    __syncthreads();  // Bs holds chunk c
    const bf16* sa = reinterpret_cast<const bf16*>(smem + st * T::STAGE) +
                     (wm * 16 * WM + lane % 16) * T::A_LD + 8 * (lane / 16);
#pragma unroll
    for (int s = 0; s < MMA_KC / 16; ++s) {
      uint32_t a[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i)
        ldsm_x4(a[i], sa + i * 16 * T::A_LD + 16 * s);
#pragma unroll
      for (int j = 0; j < WN; j += 2) {
        uint32_t b4[4];
        ldsm_x4_trans(b4, sb + 16 * s * T::B_LD + 8 * j);
        const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          mma_bf16(acc[i][j], a[i], b0);
          mma_bf16(acc[i][j + 1], a[i], b1);
        }
      }
    }
  };
  // Two chunks an iteration, so each register buffer has a fixed name.
  for (int c = 0; c < chunks; c += 2) {
    chunk(c, rw[0]);
    if (c + 1 < chunks) chunk(c + 1, rw[1]);
  }

  mma_epilogue<WM, WN>(g, acc, m0 + wm * 16 * WM, n0 + wn * 8 * WN, lane);
}

template <int WM, int WN, int MINB, int ST>
int launch_int8_mma(const Args& g, cudaStream_t stream) {
  using T = Int8Tile<WM, WN, ST>;
  static bool raised = false;
  cudaError_t err =
      allow_smem(int8_mma_kernel<WM, WN, MINB, ST>, T::SMEM, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.M + T::BM - 1) / T::BM, (g.N + T::BN - 1) / T::BN);
  int8_mma_kernel<WM, WN, MINB, ST><<<grid, THREADS, T::SMEM, stream>>>(g);
  return (int)cudaGetLastError();
}

// The decode route (M <= 8) swaps the operands: W^T is the m16n8k16 A
// (16 output columns by 16 K rows) and pre(x)^T the B (16 K rows by the 8
// tokens), so the tokens fill the n8 and no row of the product is wasted.
// A warp owns a strip of STREAM_COLS columns: lane (g, t4) loads 16
// consecutive columns, 16g .. 16g + 15, of K rows 4*t4 .. 4*t4 + 3 of each
// k16 step (four 16-byte loads), and m16 tile i takes its rows g and
// g + 8 from columns 16g + 2i and 16g + 2i + 1, its k indices 2*t4, +1,
// +8, +9 from those four rows; the lane's B registers are its token's x at
// the same four rows, one 8-byte load.
constexpr int STREAM_COLS = 128;

// The eight products of one k16 step: w[r] holds the lane's 16 columns of
// the step's K row 4*t4 + r, b its token's x at those rows.
__device__ __forceinline__ void stream_step(float (&acc)[8][4],
                                            const uint4 (&w)[4],
                                            const uint32_t (&b)[2]) {
  const uint32_t r[4][4] = {{w[0].x, w[0].y, w[0].z, w[0].w},
                            {w[1].x, w[1].y, w[1].z, w[1].w},
                            {w[2].x, w[2].y, w[2].z, w[2].w},
                            {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // Columns 4q .. 4q + 3 of rows (0, 1) and (2, 3), interleaved by row.
    const uint2 lo01 = s8x4_bf16(__byte_perm(r[0][q], r[1][q], 0x5140));
    const uint2 hi01 = s8x4_bf16(__byte_perm(r[0][q], r[1][q], 0x7362));
    const uint2 lo23 = s8x4_bf16(__byte_perm(r[2][q], r[3][q], 0x5140));
    const uint2 hi23 = s8x4_bf16(__byte_perm(r[2][q], r[3][q], 0x7362));
    const uint32_t a0[4] = {lo01.x, lo01.y, lo23.x, lo23.y};
    const uint32_t a1[4] = {hi01.x, hi01.y, hi23.x, hi23.y};
    mma_bf16(acc[2 * q], a0, b);
    mma_bf16(acc[2 * q + 1], a1, b);
  }
}

// K2 at M <= 8 after the prologue pass: block x streams the weight strip
// of columns 128x .. 128x + 127, its 8 warps over 8 slices of K. Each
// lane loads the next k16 step into registers while the products of this
// one run. The warps' sums meet in shared memory in a fixed order, and
// the block applies the epilogue.
__global__ void __launch_bounds__(THREADS, 2) int8_stream_kernel(Args g) {
  __shared__ float red[NWARPS][8][STREAM_COLS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * STREAM_COLS, n = n0 + 16 * gq;
  const int8_t* w8 = static_cast<const int8_t*>(g.w);
  const bool vec = g.ld_w % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(w8) & 15) == 0;
  const int kp = xp_cols(g.K), steps = (g.K + 15) / 16;
  const int s0 = steps * warp / NWARPS, s1 = steps * (warp + 1) / NWARPS;
  const bf16* xrow = g.xp + (size_t)min(gq, g.M - 1) * kp + 4 * t4;

  // Step j: rows 16j + 4*t4 + r of the lane's 16 columns, and its token's
  // x at those rows (zeros past M).
  uint4 w[4];
  uint32_t b[2];
  const auto load = [&](int j, uint4 (&wj)[4], uint32_t (&bj)[2]) {
    const int k = 16 * j + 4 * t4;
#pragma unroll
    for (int r = 0; r < 4; ++r) wj[r] = load_w16(g, w8, k + r, n, vec);
    uint2 xv = make_uint2(0u, 0u);
    if (gq < g.M) xv = __ldg(reinterpret_cast<const uint2*>(xrow + 16 * j));
    bj[0] = xv.x;
    bj[1] = xv.y;
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  if (s0 < s1) load(s0, w, b);
  for (int j = s0; j < s1; ++j) {
    uint4 wn[4];
    uint32_t bn[2];
    if (j + 1 < s1) load(j + 1, wn, bn);
    stream_step(acc, w, b);
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = wn[r];
    b[0] = bn[0];
    b[1] = bn[1];
  }

  // acc[i] = D of m16 tile i: rows g, g + 8 are columns 16g + 2i, + 1;
  // columns 2*t4, + 1 are tokens. red[warp][token][column].
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 16 * gq + 2 * i;
    *reinterpret_cast<float2*>(&red[warp][2 * t4][c]) =
        make_float2(acc[i][0], acc[i][2]);
    *reinterpret_cast<float2*>(&red[warp][2 * t4 + 1][c]) =
        make_float2(acc[i][1], acc[i][3]);
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 8 * STREAM_COLS / THREADS; ++p) {
    const int e = tid + p * THREADS, t = e / STREAM_COLS, c = e % STREAM_COLS;
    const int gn = n0 + c;
    if (t >= g.M || gn >= g.N) continue;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) sum += red[w][t][c];
    float y = (g.a * sum + g.b * g.rs[t]) * g.scale[gn];
    if (g.bias) y += g.bias[gn];
    const size_t o = (size_t)t * g.N + gn;
    if (g.res) y += to_f(g.res[o]);
    g.out[o] = __float2bfloat16_rn(y);
  }
}

// K2: the prologue pass, then at M <= 8 the streaming kernel, else the
// tensor-core kernel: 128 x 128 tiles at two blocks an SM where they fill
// the card twice over (M > 64), 64 x 128 where those do (six stages of A:
// the weight stream then bounds it), else 32 x 64. Measured on OPT-1.3B's
// head (PERF.md).
int launch_int8_m(const Args& g, cudaStream_t stream) {
  if (!g.xp || !g.rs) return (int)cudaErrorInvalidValue;
  int err = launch_prologue(g, stream);
  if (err != cudaSuccess) return err;
  if (g.M <= 8) {
    const int strips = (g.N + STREAM_COLS - 1) / STREAM_COLS;
    int8_stream_kernel<<<strips, THREADS, 0, stream>>>(g);
    return (int)cudaGetLastError();
  }
  const auto blocks = [&](int bm, int bn) {
    return ((g.M + bm - 1) / bm) * ((g.N + bn - 1) / bn);
  };
  if (g.M > 64 && blocks(128, 128) >= 264)
    return launch_int8_mma<4, 4, 2, 3>(g, stream);
  if (blocks(64, 128) >= 132) return launch_int8_mma<2, 4, 2, 6>(g, stream);
  return launch_int8_mma<1, 2, 1, 3>(g, stream);
}

}  // namespace

// K1. x (M, x_cols) bf16 (x_cols = K, or 2K for silu_glu); words (kw, N)
// int32 'pair'; scale/bias (N,) f32 (bias may be null); ln_s/ln_b (K,)
// f32 or bf16 (ln_bf16); res (M, N) bf16 or null; out (M, N) bf16; xp
// (M, K rounded up to 64) bf16 and rs (M,) f32, scratch of the M > 8 route
// (an M > 8 call without them returns cudaErrorInvalidValue; M <= 8 reads
// neither). The product runs over the centred weight C - 1.5, so b must be
// the rowsum coefficient of that fold: b_aff + 1.5 * a_aff.
extern "C" int pair_matmul(const void* x, const void* words,
                           const void* scale, const void* bias,
                           const void* ln_s, const void* ln_b, int ln_bf16,
                           const void* res, void* out, void* xp, void* rs,
                           int M, int N, int K, int x_cols, int kw, int nbits,
                           int pre, float a, float b, float eps,
                           void* stream) {
  Args g{static_cast<const bf16*>(x), words,
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         ln_s, ln_b, ln_bf16, static_cast<const bf16*>(res),
         static_cast<bf16*>(out), M, N, K, x_cols, kw, N, pre, a, b, eps,
         static_cast<bf16*>(xp), static_cast<float*>(rs)};
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
                             const void* res, void* out, void* xp, void* rs,
                             int M, int N, int K, int x_cols, int kw, int pre,
                             float a, float b, float eps, void* stream) {
  return pair3_entry<Pair3x>(x, words, scale, bias, ln_s, ln_b, ln_bf16, res,
                             out, xp, rs, M, N, K, x_cols, kw, pre, a, b, eps,
                             stream);
}

extern "C" int pair3_matmul(const void* x, const void* words,
                            const void* scale, const void* bias,
                            const void* ln_s, const void* ln_b, int ln_bf16,
                            const void* res, void* out, void* xp, void* rs,
                            int M, int N, int K, int x_cols, int kw, int pre,
                            float a, float b, float eps, void* stream) {
  return pair3_entry<Pair3>(x, words, scale, bias, ln_s, ln_b, ln_bf16, res,
                            out, xp, rs, M, N, K, x_cols, kw, pre, a, b, eps,
                            stream);
}

// K2. x (M, K) bf16; w8 (Kp, Np) int8, Kp >= K; out (M, N) bf16 with
// N <= Np (the padded vocab columns are never written); xp (M, K rounded
// up to 64) bf16 and rs (M,) f32, the prologue pass's scratch at every M
// (a call without them returns cudaErrorInvalidValue); other arguments
// as K1, with b the rowsum coefficient of the signed bytes: zero + 128 *
// step.
extern "C" int int8_matmul(const void* x, const void* w8, const void* scale,
                           const void* bias, const void* ln_s,
                           const void* ln_b, int ln_bf16, const void* res,
                           void* out, void* xp, void* rs, int M, int N,
                           int K, int Kp, int Np, int pre, float a, float b,
                           float eps,
                           void* stream) {
  Args g{static_cast<const bf16*>(x), w8, static_cast<const float*>(scale),
         static_cast<const float*>(bias), ln_s, ln_b, ln_bf16,
         static_cast<const bf16*>(res), static_cast<bf16*>(out), M, N, K, K,
         Kp, Np, pre, a, b, eps, static_cast<bf16*>(xp),
         static_cast<float*>(rs)};
  return launch_int8_m(g, static_cast<cudaStream_t>(stream));
}
