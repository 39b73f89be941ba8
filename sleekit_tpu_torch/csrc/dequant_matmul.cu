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
// K1, K6, K7 and K2 share one route rule. Every call first runs
// prologue_kernel, which writes pre(x) once, as bf16 into the scratch xp
// (M, K rounded up to 64, 0 past K), with its row sums in rs (norm
// statistics and activations are never recomputed per block). Then:
// - M > 8, pair_mma_kernel: xp times the words on the tensor cores
//   (mma.sync m16n8k16 bf16, f32 accumulation). A pair word holds K rows
//   2p and 2p+1 of one column as two bf16 mantissas, the layout of one
//   .b32 register of an m16n8k16 B fragment, so B is built in registers
//   straight from the words (shift, mask, OR the exponent, one exact
//   bf16x2 FMA to centre it) and no dequantized tile exists in shared
//   memory. A and the words arrive by cp.async in a ring of three 64-row
//   stages; A fragments come from shared memory by ldmatrix.
// - M <= 8, pair_stream_kernel: bound by the word stream, so the operands
//   swap: the decoded weight is the m16n8k16 A operand (16 output columns
//   by 16 K rows; the same word is one A register, row = column, k = two
//   consecutive K rows) and the <= 8 tokens are the n8 B operand, one
//   8-byte load of xp per lane and k16 step, so no product row is wasted.
//   Each lane loads 16 bytes along N (four columns of one word row) and
//   every word it loads serves all of its planes; the next unit's words
//   and x are in flight in registers while this unit's products run. The
//   kernel is the prologue pass's programmatic dependent, so its blocks
//   start, and load their first words, while the pass runs. K is split
//   over a block's 8 warps and, where the column strips alone would leave
//   SMs idle, over blocks; the partial sums meet in a fixed order (warps
//   in a block through shared memory, blocks through a scratch of
//   partials and a ticket per strip: the last block to arrive adds them
//   in split order), so a call is bit for bit the same on every run.
//   What still bounds it at OPT-1.3B's shapes is latency, not the stream:
//   the prologue pass, the launch and the split-K tail take about as long
//   as the words (PERF.md).
// The decoders are shared: pair_reg (plane j of a 'pair' word), p4_reg
// ('pair3x' 4-bit fields) and pair3_b ('pair3' low and high words) build
// a bf16x2 register of the centred weight for either operand.
//
// The product runs over C - 1.5 (one exact subtraction): over C itself,
// the fold a*acc + b*rowsum cancels catastrophically when x has a large
// mean (after relu, rowsum ~ 2000 against a result ~ 7 at OPT-1.3B's fc2),
// and the f32 rounding of acc then flips about one bf16 output in ten.
// K6 and K7 are K1's kernels under another tile rule (the template
// parameter P). A pair3 index keeps its 2 low bits in low word p (rows
// j*32 + 2p + h) and its high bit in high word p % 8, plane 2j + p/8 (the
// same rows); both parts OR into one bf16 mantissa, C = 1 + idx/8;
// pair3x's 4-bit fields give 4 + idx/4 as the TPU kernel builds them.
// Each value goes into the product minus its midpoint (2*(C - 1.4375) and
// 4 + idx/4 - 4.875, both idx/4 - 0.875, exact), so both layouts fold a =
// 4*step and b = zero + 3.5*step. The TPU kernel's pair3x epilogue
// instead subtracts a section-weighted rowsum from a*acc, two large,
// nearly equal terms. The tensor-core kernels use mma.sync, not wgmma,
// and cp.async or plain loads, not TMA.
//
// K2 (the int8 head, OPT-1.3B: 2048 x 51200 bytes, 106 MB), after the
// prologue pass:
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
//   the n8, as in pair_stream_kernel, with the next k16 step's loads in
//   flight; K is split across a block's 8 warps, whose sums meet in a
//   fixed order.
#include "common.cuh"

namespace {

enum Pre { PRE_NONE = 0, PRE_LN = 1, PRE_RMS = 2, PRE_RELU = 3, PRE_GELU = 4,
           PRE_GLU = 5 };

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// Columns a decode block of K1/K6/K7 streams (pair_stream_kernel): lane
// (g, t4) of each warp holds columns 4g .. 4g + 3 of the strip.
constexpr int PAIR_COLS = 32;

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
  bf16* xp;   // the prologue pass's scratch: pre(x), (M, xp_cols(K))
  float* rs;  // and its row sums, (M,)
};

// K1/K6/K7's K split over blocks at M <= 8: splits slices, and above one
// the partial sums (splits, M, N) and one ticket per column strip. Kept
// out of Args: a larger Args made int8_mma_kernel 11% slower at M = 64
// (PERF.md).
struct Split {
  float* part;
  int* tickets;
  int splits;
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

// Tile rules: PG word rows per tile, BK K rows per tile. 'pair' has HP
// planes per 16-bit half; a plane spans 2*PG K rows, word row p holding
// rows 2p and 2p + 1 of it.
enum TileKind { TILE_PAIR = 0, TILE_PAIR3 = 1, TILE_PAIR3X = 2 };

template <int NB>
struct Pair {
  static constexpr int KIND = TILE_PAIR;
  static constexpr int NBITS = NB;
  static constexpr int HP = 16 / NB;
  static constexpr int PG = (HP % 2) ? 64 : 32;
  static constexpr int BK = 2 * PG * HP;
};

// 'pair3': 24 word rows per 256-row tile, 16 low words then 8 high words.
struct Pair3 {
  static constexpr int KIND = TILE_PAIR3;
  static constexpr int PG = 24, BK = 256;
};

// 'pair3x': 56 word rows per 512-row group, 32 4-bit words then one pair3
// tile.
struct Pair3x {
  static constexpr int KIND = TILE_PAIR3X;
  static constexpr int PG = 56, BK = 512;
};

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
// statistics (mean for layernorm, then 1/sqrt(var + eps)) run over the
// valid K in two passes. Block 0 also zeroes the decode route's tickets
// (one per PAIR_COLS-column strip; null for the other routes), which the
// kernel after it on the same stream counts up.
template <int W>
__global__ void __launch_bounds__(THREADS) prologue_kernel(Args g,
                                                            int* tickets) {
  __shared__ float red[NWARPS];
  const int tid = threadIdx.x, m = blockIdx.x;
  // A kernel launched after this one as its programmatic dependent (the
  // decode route's) may start now: it loads its words, then waits for
  // this grid before it reads xp, rs or the tickets.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
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
  if (tickets && m == 0)
    for (int i = tid; i < (g.N + PAIR_COLS - 1) / PAIR_COLS; i += THREADS)
      tickets[i] = 0;
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

// The decoders. Each builds one bf16x2 register of the centred weight, K
// rows 2p (low half) and 2p + 1 of one column: a B register of the
// tensor-core route (k = two consecutive K rows of one column) or an A
// register of the decode route (row = that column).

// Plane j of a 'pair' word of NB-bit fields: the bf16 bit patterns C = 1 +
// idx/2^NB (one shift, AND, OR), then C - 1.5.
template <int NB>
__device__ __forceinline__ uint32_t pair_reg(uint32_t w, int j) {
  constexpr uint32_t mlow = ((1u << NB) - 1u) << (7 - NB);
  const uint32_t u = (((w >> (NB * j)) << (7 - NB)) & (mlow | mlow << 16)) |
                     0x3F803F80u;
  return bf2_fma(u, 1.0f, -1.5f);
}

// Plane j (< 4) of a 'pair3x' 4-bit word (top bit of each field 0): the
// field ORs under exponent 129, 4 + idx/4, then minus 4.875.
__device__ __forceinline__ uint32_t p4_reg(uint32_t w, int j) {
  const uint32_t u = (((w >> (4 * j)) << 3) & 0x00780078u) | 0x40804080u;
  return bf2_fma(u, 1.0f, -4.875f);
}

// A pair3 register: low word wl, plane j (2-bit fields) and high word
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
    const int j = c % (P::BK / MMA_KC) / (P::PG / 32);  // the chunk's plane
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b[h] = pair_reg<P::NBITS>((uint32_t)ws[(8 * s + 4 * h + t4) * ld], j);
  } else if constexpr (P::KIND == TILE_PAIR3) {
    pair3_frag(ws, ld, 4 * (c & 3) + s, t4, b);
  } else if constexpr (PART == 0) {  // 4-bit fields, plane c % 8 (< 4)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      b[h] = p4_reg((uint32_t)ws[(8 * s + 4 * h + t4) * ld], c & 7);
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
  static int raised = 0;
  cudaError_t err =
      allow_smem(pair_mma_kernel<P, WM, WN, MINB>, T::SMEM, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.N + T::BN - 1) / T::BN, (g.M + T::BM - 1) / T::BM);
  pair_mma_kernel<P, WM, WN, MINB><<<grid, THREADS, T::SMEM, stream>>>(g);
  return (int)cudaGetLastError();
}

// ---- the decode route (M <= 8) ------------------------------------------

// Whether the decode route's epilogue may store two columns as one
// bf16x2: N even and the output and residual 4-byte aligned.
__device__ __forceinline__ bool pair_stores(const Args& g) {
  return g.N % 2 == 0 && (reinterpret_cast<uintptr_t>(g.out) & 3) == 0 &&
         (reinterpret_cast<uintptr_t>(g.res) & 3) == 0;
}

// Its operands of output row m, columns n and n + 1 (n < g.N; column n +
// 1 only below g.N): scale, bias and residual (0 where absent), the
// residual pair as one bf16x2 load where pairs. The output (and the
// residual) is g.N columns wide.
struct Epi {
  float s[2], b[2], r[2];
};

__device__ __forceinline__ Epi epi_load(const Args& g, int m, int n,
                                        bool pairs) {
  Epi e = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  const bool two = n + 1 < g.N;
  const size_t o = (size_t)m * g.N + n;
  e.s[0] = g.scale[n];
  if (two) e.s[1] = g.scale[n + 1];
  if (g.bias) {
    e.b[0] = g.bias[n];
    if (two) e.b[1] = g.bias[n + 1];
  }
  if (g.res) {
    if (two && pairs) {
      const float2 r = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g.res + o));
      e.r[0] = r.x;
      e.r[1] = r.y;
    } else {
      e.r[0] = to_f(g.res[o]);
      if (two) e.r[1] = to_f(g.res[o + 1]);
    }
  }
  return e;
}

// Output row m, columns n and n + 1 (if < g.N), from their sums v0, v1
// and operands e: (a*v + brs)*scale + bias [+ res], brs = b*rs[m]; one
// bf16x2 store where pairs.
__device__ __forceinline__ void store_pair(const Args& g, int m, int n,
                                           float v0, float v1, float brs,
                                           const Epi& e, bool pairs) {
  const size_t o = (size_t)m * g.N + n;
  float y0 = (g.a * v0 + brs) * e.s[0];
  if (g.bias) y0 += e.b[0];
  if (g.res) y0 += e.r[0];
  if (n + 1 < g.N) {
    float y1 = (g.a * v1 + brs) * e.s[1];
    if (g.bias) y1 += e.b[1];
    if (g.res) y1 += e.r[1];
    if (pairs) {
      *reinterpret_cast<__nv_bfloat162*>(g.out + o) =
          __floats2bfloat162_rn(y0, y1);
      return;
    }
    g.out[o + 1] = __float2bfloat16_rn(y1);
  }
  g.out[o] = __float2bfloat16_rn(y0);
}

// The decode route walks K in units of word rows, each word loaded once
// for all of its planes: 'pair' 8 word rows of a tile (one k16 step in
// each of its HP planes); 'pair3' the 8 low words of one half of a tile
// with the tile's 8 high words (8 steps); 'pair3x' per 512-row group its
// four eights of 4-bit words (4 steps each), then its pair3 tile's two
// halves. RW word rows a lane loads per unit, STEPS k16 steps at most.
template <class P>
constexpr int stream_steps() {
  if constexpr (P::KIND == TILE_PAIR) return P::HP;
  else return 8;
}

template <class P>
struct Stream {
  static constexpr int RW = P::KIND == TILE_PAIR ? 2 : 4;
  static constexpr int STEPS = stream_steps<P>();
};

// Units of kw word rows (ops/dequant_matmul.py stream_units mirrors it).
template <class P>
__device__ __forceinline__ int stream_units(int kw) {
  if constexpr (P::KIND == TILE_PAIR) return kw / 8;
  else if constexpr (P::KIND == TILE_PAIR3) return kw / P::PG * 2;
  else return kw / P::PG * 6;
}

constexpr int NO_ROW = 1 << 30;

// The first K row of step s of unit u (a multiple of 16), or NO_ROW.
template <class P>
__device__ __forceinline__ int step_row(int u, int s) {
  if constexpr (P::KIND == TILE_PAIR) {
    const int w = 8 * u;
    return w / P::PG * P::BK + 2 * (w % P::PG) + s * 2 * P::PG;
  } else if constexpr (P::KIND == TILE_PAIR3) {
    return (u >> 1) * P::BK + 16 * (2 * s + (u & 1));
  } else {
    const int r = u % 6, k0 = u / 6 * P::BK;
    if (r < 4) return s < 4 ? k0 + 64 * s + 16 * r : NO_ROW;
    return k0 + 256 + 16 * (2 * s + r - 4);
  }
}

// The word rows lane t4 loads for unit u. Rows 0 and 1 give the lane's A
// registers at k = 2*t4, +1 and k = 2*t4 + 8, +9 of every step: the K rows
// 4*t4 .. 4*t4 + 3 of the step (the same permutation of k as its x load).
// For the 3-bit rules rows 2 and 3 are the pair3 tile's high words, -1
// where the unit has none.
template <class P>
__device__ __forceinline__ void unit_rows(int u, int t4,
                                          int (&r)[Stream<P>::RW]) {
  if constexpr (P::KIND == TILE_PAIR) {
    r[0] = 8 * u + 2 * t4;
  } else if constexpr (P::KIND == TILE_PAIR3) {
    const int t = (u >> 1) * P::PG;
    r[0] = t + 8 * (u & 1) + 2 * t4;
    r[2] = t + 16 + 2 * t4;
  } else {
    const int q = u % 6, t = u / 6 * P::PG;
    r[0] = q < 4 ? t + 8 * q + 2 * t4 : t + 32 + 8 * (q - 4) + 2 * t4;
    r[2] = q < 4 ? -1 : t + 48 + 2 * t4;
  }
  r[1] = r[0] + 1;
  if constexpr (Stream<P>::RW == 4) r[3] = r[2] < 0 ? -1 : r[2] + 1;
}

// Columns n .. n + 3 of word row r: one 16-byte load where vec, else four
// 4-byte ones; zeros past the matrix or for r < 0.
__device__ __forceinline__ void load_cols(const int* words, int r, int kw,
                                          int N, int n, bool vec,
                                          uint32_t (&w)[4]) {
  w[0] = w[1] = w[2] = w[3] = 0u;
  if (r < 0 || r >= kw) return;
  const int* p = words + (size_t)r * N + n;
  if (vec) {
    if (n < N) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n + c < N) w[c] = (uint32_t)__ldg(p + c);
  }
}

// The products of unit u: w[i][c] holds the lane's column c of its word
// row i, x[s] its token's x at the K rows 4*t4 .. 4*t4 + 3 of step s. m16
// tile i takes its rows g and g + 8 from the lane's columns 2i and 2i + 1.
// Steps at or past K are skipped (their x is 0; the words there decode to
// nonzero weights).
template <class P>
__device__ __forceinline__ void stream_unit(
    float (&acc)[2][4], const uint32_t (&w)[Stream<P>::RW][4],
    const uint32_t (&x)[Stream<P>::STEPS][2], int u, int K) {
  if constexpr (P::KIND == TILE_PAIR) {
#pragma unroll
    for (int j = 0; j < P::HP; ++j) {
      if (step_row<P>(u, j) >= K) break;  // the rows grow with the plane
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t a[4] = {pair_reg<P::NBITS>(w[0][2 * i], j),
                               pair_reg<P::NBITS>(w[0][2 * i + 1], j),
                               pair_reg<P::NBITS>(w[1][2 * i], j),
                               pair_reg<P::NBITS>(w[1][2 * i + 1], j)};
        mma_bf16(acc[i], a, x[j]);
      }
    }
  } else {
    if (P::KIND == TILE_PAIR3X && u % 6 < 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t a[4] = {p4_reg(w[0][2 * i], j),
                                 p4_reg(w[0][2 * i + 1], j),
                                 p4_reg(w[1][2 * i], j),
                                 p4_reg(w[1][2 * i + 1], j)};
          mma_bf16(acc[i], a, x[j]);
        }
      }
      return;
    }
    const int hf = P::KIND == TILE_PAIR3 ? (u & 1) : u % 6 - 4;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (step_row<P>(u, q) >= K) break;
      const int S = 2 * q + hf;  // low plane q, high plane S
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c0 = 2 * i, c1 = 2 * i + 1;
        const uint32_t a[4] = {pair3_b(w[0][c0], w[2][c0], q, S),
                               pair3_b(w[0][c1], w[2][c1], q, S),
                               pair3_b(w[1][c0], w[3][c0], q, S),
                               pair3_b(w[1][c1], w[3][c1], q, S)};
        mma_bf16(acc[i], a, x[q]);
      }
    }
  }
}

// K1/K6/K7 at M <= 8 after the prologue pass: block (x, y) streams the
// PAIR_COLS-column strip x over K slice y of sp.splits (units in equal
// shares), its 8 warps over 8 sub-slices. Each lane keeps the next
// unit's words and x in flight in registers while this unit's products
// run. The warps' sums meet in shared memory in warp order; with one
// slice the block applies the epilogue, else it writes its sums to
// sp.part, and the last block of the strip to take a ticket adds the
// slices in slice order and applies it.
template <class P>
__global__ void __launch_bounds__(THREADS, 2)
    pair_stream_kernel(Args g, Split sp) {
  using S = Stream<P>;
  __shared__ float4 red[NWARPS][8][PAIR_COLS / 4];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * PAIR_COLS, n = n0 + 4 * gq;
  const int* words = static_cast<const int*>(g.w);
  const bool vec = g.N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  const int units = stream_units<P>(g.kw);
  const int b0 = units * blockIdx.y / sp.splits;
  const int b1 = units * (blockIdx.y + 1) / sp.splits;
  const int u0 = b0 + (b1 - b0) * warp / NWARPS;
  const int u1 = b0 + (b1 - b0) * (warp + 1) / NWARPS;
  const bool tok = gq < g.M;  // the lane's token (the n8 column g)
  const bf16* xrow = g.xp + (size_t)(tok ? gq : 0) * xp_cols(g.K) + 4 * t4;

  const auto load_w = [&](int u, uint32_t (&wu)[S::RW][4]) {
    int r[S::RW];
    unit_rows<P>(u, t4, r);
#pragma unroll
    for (int i = 0; i < S::RW; ++i)
      load_cols(words, r[i], g.kw, g.N, n, vec, wu[i]);
  };
  const auto load_x = [&](int u, uint32_t (&xu)[S::STEPS][2]) {
#pragma unroll
    for (int s = 0; s < S::STEPS; ++s) {
      const int k = step_row<P>(u, s);
      uint2 v = make_uint2(0u, 0u);
      if (tok && k < g.K) v = __ldg(reinterpret_cast<const uint2*>(xrow + k));
      xu[s][0] = v.x;
      xu[s][1] = v.y;
    }
  };

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  // A ring of D units in registers: unit u0 + v lives in buffer v % D,
  // and unit u + D - 1 loads while the products of unit u run. A third
  // unit takes enough registers to cost the int4 rule one block an SM,
  // and was slower on OPT-1.3B's shapes (PERF.md).
  constexpr int D = 2;
  uint32_t w[D][S::RW][4], x[D][S::STEPS][2];
#pragma unroll
  for (int d = 0; d < D - 1; ++d)
    if (u0 + d < u1) load_w(u0 + d, w[d]);
  // Thread tid < 8 * PAIR_COLS / 2 of the epilogue: token t, columns c and
  // c + 1, whose operands load now.
  const int t = tid / (PAIR_COLS / 2), c = 2 * (tid % (PAIR_COLS / 2));
  const int nc = n0 + c;
  const bool mine = tid < 8 * PAIR_COLS / 2 && t < g.M && nc < g.N;
  const bool pairs = pair_stores(g);
  Epi epi = {};
  if (mine) epi = epi_load(g, t, nc, pairs);
  // The words, scale, bias and residual do not depend on the prologue
  // pass launched before this kernel (launch_pair_m makes it its
  // programmatic dependent); xp, rs and the tickets do.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float brs = mine ? g.b * g.rs[t] : 0.0f;
#pragma unroll
  for (int d = 0; d < D - 1; ++d)
    if (u0 + d < u1) load_x(u0 + d, x[d]);
  for (int u = u0; u < u1; u += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int ahead = u + d + D - 1;
      if (ahead < u1) {
        load_w(ahead, w[(d + D - 1) % D]);
        load_x(ahead, x[(d + D - 1) % D]);
      }
      if (u + d < u1) stream_unit<P>(acc, w[d], x[d], u + d, g.K);
    }
  }

  // acc[i][e]: the lane's column 2i (e < 2) or 2i + 1 (e >= 2), token
  // 2*t4 + e % 2. red[warp][token][column / 4].
  red[warp][2 * t4][gq] =
      make_float4(acc[0][0], acc[0][2], acc[1][0], acc[1][2]);
  red[warp][2 * t4 + 1][gq] =
      make_float4(acc[0][1], acc[0][3], acc[1][1], acc[1][3]);
  __syncthreads();
  const float* rf = reinterpret_cast<const float*>(red);
  float s0 = 0.0f, s1 = 0.0f;
  if (mine)
#pragma unroll
    for (int v = 0; v < NWARPS; ++v) {
      s0 += rf[(v * 8 + t) * PAIR_COLS + c];
      s1 += rf[(v * 8 + t) * PAIR_COLS + c + 1];
    }
  if (sp.splits == 1) {
    if (mine) store_pair(g, t, nc, s0, s1, brs, epi, pairs);
    return;
  }
  if (mine) {
    float* p = sp.part + ((size_t)blockIdx.y * g.M + t) * g.N + nc;
    p[0] = s0;
    if (nc + 1 < g.N) p[1] = s1;
  }
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (tid == 0) last = atomicAdd(sp.tickets + blockIdx.x, 1) == sp.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (mine) {
    s0 = s1 = 0.0f;
    for (int y = 0; y < sp.splits; ++y) {
      const float* p = sp.part + ((size_t)y * g.M + t) * g.N + nc;
      s0 += __ldcg(p);
      if (nc + 1 < g.N) s1 += __ldcg(p + 1);
    }
    store_pair(g, t, nc, s0, s1, brs, epi, pairs);
  }
}

// The prologue pass: 16-byte loads and stores where K % 8 == 0 and the
// rows and norm parameters are aligned, else one column a thread.
int launch_prologue(const Args& g, int* tickets, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool norm = g.pre == PRE_LN || g.pre == PRE_RMS;
  if (g.K % 8 == 0 && aligned(g.x) &&
      (!norm || (aligned(g.ln_s) && aligned(g.ln_b))))
    prologue_kernel<8><<<g.M, THREADS, 0, stream>>>(g, tickets);
  else
    prologue_kernel<1><<<g.M, THREADS, 0, stream>>>(g, tickets);
  return (int)cudaGetLastError();
}

// The prologue pass, then at M <= 8 the streaming kernel (its
// programmatic dependent) over (strips, sp.splits) blocks (sp.splits >=
// 1; above 1 it needs sp.part and sp.tickets), else the tensor-core
// kernel in 128 x 128 tiles, two blocks an SM where they fill the card
// twice over (264 blocks; fewer registers, more warps), else one; or in
// 32 x 64 tiles where the large ones would leave more than half the SMs
// idle (fewer than 64 blocks). Measured on OPT-1.3B's projections
// (PERF.md).
template <class P>
int launch_pair_m(const Args& g, const Split& sp, cudaStream_t stream) {
  if (!g.xp || !g.rs) return (int)cudaErrorInvalidValue;
  const bool stream_route = g.M <= 8;
  if (stream_route &&
      (sp.splits < 1 || (sp.splits > 1 && (!sp.part || !sp.tickets))))
    return (int)cudaErrorInvalidValue;
  const int err = launch_prologue(
      g, stream_route && sp.splits > 1 ? sp.tickets : nullptr, stream);
  if (err != cudaSuccess) return err;
  if (stream_route) {
    // A programmatic dependent of the prologue pass: its blocks start
    // while the pass runs and load their first words.
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((g.N + PAIR_COLS - 1) / PAIR_COLS, sp.splits);
    cfg.blockDim = dim3(THREADS);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, pair_stream_kernel<P>, g, sp);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  using Wide = MmaTile<4, 4>;
  const int wide = ((g.M + Wide::BM - 1) / Wide::BM) *
                   ((g.N + Wide::BN - 1) / Wide::BN);
  if (wide >= 264) return launch_mma<P, 4, 4, 2>(g, stream);
  if (wide >= 64) return launch_mma<P, 4, 4, 1>(g, stream);
  return launch_mma<P, 1, 2, 1>(g, stream);
}

Args pair_args(const void* x, const void* words, const void* scale,
               const void* bias, const void* ln_s, const void* ln_b,
               int ln_bf16, const void* res, void* out, void* xp, void* rs,
               int M, int N, int K, int x_cols, int kw, int pre, float a,
               float b, float eps) {
  return Args{static_cast<const bf16*>(x), words,
              static_cast<const float*>(scale),
              static_cast<const float*>(bias), ln_s, ln_b, ln_bf16,
              static_cast<const bf16*>(res), static_cast<bf16*>(out), M, N,
              K, x_cols, kw, N, pre, a, b, eps, static_cast<bf16*>(xp),
              static_cast<float*>(rs)};
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
  static int raised = 0;
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
  int err = launch_prologue(g, nullptr, stream);
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
// (M, K rounded up to 64) bf16 and rs (M,) f32, the prologue pass's
// scratch at every M; at M <= 8, splits >= 1 K slices over blocks, and
// above 1 the scratch part (splits, M, N) f32 and tickets, one int32 per
// 32-column strip (a call without the scratch it needs returns
// cudaErrorInvalidValue). The product runs over the centred weight C -
// 1.5, so b must be the rowsum coefficient of that fold: b_aff + 1.5 *
// a_aff.
extern "C" int pair_matmul(const void* x, const void* words,
                           const void* scale, const void* bias,
                           const void* ln_s, const void* ln_b, int ln_bf16,
                           const void* res, void* out, void* xp, void* rs,
                           void* part, void* tickets, int M, int N, int K,
                           int x_cols, int kw, int splits, int nbits,
                           int pre, float a, float b, float eps,
                           void* stream) {
  const Args g = pair_args(x, words, scale, bias, ln_s, ln_b, ln_bf16, res,
                           out, xp, rs, M, N, K, x_cols, kw, pre, a, b, eps);
  const Split sp{static_cast<float*>(part), static_cast<int*>(tickets),
                 splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return launch_pair_m<Pair<1>>(g, sp, s);
    case 2: return launch_pair_m<Pair<2>>(g, sp, s);
    case 3: return launch_pair_m<Pair<3>>(g, sp, s);
    case 4: return launch_pair_m<Pair<4>>(g, sp, s);
    case 5: return launch_pair_m<Pair<5>>(g, sp, s);
    case 6: return launch_pair_m<Pair<6>>(g, sp, s);
    case 7: return launch_pair_m<Pair<7>>(g, sp, s);
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
                             void* part, void* tickets, int M, int N, int K,
                             int x_cols, int kw, int splits, int pre, float a,
                             float b, float eps, void* stream) {
  return launch_pair_m<Pair3x>(
      pair_args(x, words, scale, bias, ln_s, ln_b, ln_bf16, res, out, xp, rs,
                M, N, K, x_cols, kw, pre, a, b, eps),
      Split{static_cast<float*>(part), static_cast<int*>(tickets), splits},
      static_cast<cudaStream_t>(stream));
}

extern "C" int pair3_matmul(const void* x, const void* words,
                            const void* scale, const void* bias,
                            const void* ln_s, const void* ln_b, int ln_bf16,
                            const void* res, void* out, void* xp, void* rs,
                            void* part, void* tickets, int M, int N, int K,
                            int x_cols, int kw, int splits, int pre, float a,
                            float b, float eps, void* stream) {
  return launch_pair_m<Pair3>(
      pair_args(x, words, scale, bias, ln_s, ln_b, ln_bf16, res, out, xp, rs,
                M, N, K, x_cols, kw, pre, a, b, eps),
      Split{static_cast<float*>(part), static_cast<int*>(tickets), splits},
      static_cast<cudaStream_t>(stream));
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
