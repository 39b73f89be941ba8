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
// K1, K6 and K7 run the two routes of dequant_routes.cuh (the prologue
// pass, then pair_stream_kernel at M <= 8, pair_mma_kernel above) under
// the 'pair' family's tile rules (PairRule). A pair word holds K rows 2p
// and 2p+1 of one column as two bf16 mantissas, the layout of one .b32
// register of an m16n8k16 fragment (B on the tensor-core route: k = two
// consecutive K rows of one column; A on the decode route: row = that
// column), so each register is built from one word (shift, mask, OR the
// exponent, one exact bf16x2 FMA to centre it). What still bounds the
// decode route at OPT-1.3B's shapes is latency, not the stream: the
// prologue pass, the launch and the split-K tail take about as long as
// the words (PERF.md).
// The decoders: pair_reg (plane j of a 'pair' word), p4_reg ('pair3x'
// 4-bit fields) and pair3_b ('pair3' low and high words) build a bf16x2
// register of the centred weight for either operand.
//
// The product runs over C - 1.5 (one exact subtraction): over C itself,
// the fold a*acc + b*rowsum cancels catastrophically when x has a large
// mean (after relu, rowsum ~ 2000 against a result ~ 7 at OPT-1.3B's fc2),
// and the f32 rounding of acc then flips about one bf16 output in ten.
// K6 and K7 are K1's kernels under another tile rule. A pair3 index keeps
// its 2 low bits in low word p (rows j*32 + 2p + h) and its high bit in
// high word p % 8, plane 2j + p/8 (the same rows); both parts OR into one
// bf16 mantissa, C = 1 + idx/8; pair3x's 4-bit fields give 4 + idx/4 as
// the TPU kernel builds them. Each value goes into the product minus its
// midpoint (2*(C - 1.4375) and 4 + idx/4 - 4.875, both idx/4 - 0.875,
// exact), so both layouts fold a = 4*step and b = zero + 3.5*step. The TPU
// kernel's pair3x epilogue instead subtracts a section-weighted rowsum
// from a*acc, two large, nearly equal terms. The tensor-core kernels use
// mma.sync, not wgmma, and cp.async or plain loads, not TMA.
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
#include "dequant_routes.cuh"

namespace {

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

// The 'pair' family's tile rules: PG word rows per tile, BK K rows per
// tile. 'pair' has HP planes per 16-bit half; a plane spans 2*PG K rows,
// word row p holding rows 2p and 2p + 1 of it. 'pair3': 24 word rows per
// 256-row tile, 16 low words then 8 high words. 'pair3x': 56 word rows per
// 512-row group, 32 4-bit words then one pair3 tile.
enum TileKind { TILE_PAIR = 0, TILE_PAIR3 = 1, TILE_PAIR3X = 2 };

template <int KIND_, int NB, int PG_, int BK_>
struct PairRule {
  static constexpr int KIND = KIND_, NBITS = NB, PG = PG_, BK = BK_;
  static constexpr int HP = 16 / NB;
  static constexpr int WPAD = 8;
  // The decode route walks K in units of word rows, each word loaded once
  // for all of its planes: 'pair' 8 word rows of a tile (one k16 step in
  // each of its HP planes); 'pair3' the 8 low words of one half of a tile
  // with the tile's 8 high words (8 steps); 'pair3x' per 512-row group its
  // four eights of 4-bit words (4 steps each), then its pair3 tile's two
  // halves.
  static constexpr int RW = KIND == TILE_PAIR ? 2 : 4;
  static constexpr int STEPS = KIND == TILE_PAIR ? HP : 8;

  static __device__ __forceinline__ const uint32_t* setup() { return nullptr; }

  // The word rows of 64-row chunk c (K rows 64c .. 64c + 63): (first,
  // count), count <= MMA_KW. 'pair': a plane spans 2*PG K rows, word row p
  // holding rows 2p, 2p+1, so a chunk reads 32 word rows of its tile (all
  // of them when PG = 32, one half when PG = 64); 'pair3': all 24 words of
  // its 256-row tile; 'pair3x': the 32 4-bit words or the 24 pair3 words
  // of its 512-row group.
  static __device__ __forceinline__ int2 chunk_words(int c) {
    if constexpr (KIND == TILE_PAIR) {
      constexpr int CPT = BK / MMA_KC, HALVES = PG / 32;
      return make_int2(c / CPT * PG + (c % CPT % HALVES) * 32, 32);
    } else if constexpr (KIND == TILE_PAIR3) {
      return make_int2((c >> 2) * PG, 24);
    } else {
      const bool p4 = (c & 7) < 4;
      return make_int2((c >> 3) * PG + (p4 ? 0 : 32), p4 ? 32 : 24);
    }
  }

  // Lane (g = l/4, t4 = l%4)'s B registers of k16 step s of chunk c, for
  // the column whose chunk words are ws[r * ld] (r from chunk_words'
  // first): register h holds K rows 8h + 2*t4 and + 1 of the step, the
  // lower row in the low half, which is one word's plane. PART selects a
  // 'pair3x' chunk's kind (0: its 4-bit fields, chunks c % 8 < 4; 1: its
  // pair3 tile) at compile time.
  template <int PART>
  static __device__ __forceinline__ void b_frag(const int* ws, int ld, int c,
                                                int s, int t4,
                                                uint32_t (&b)[2]) {
    if constexpr (KIND == TILE_PAIR) {
      const int j = c % (BK / MMA_KC) / (PG / 32);  // the chunk's plane
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b[h] = pair_reg<NB>((uint32_t)ws[(8 * s + 4 * h + t4) * ld], j);
    } else if constexpr (KIND == TILE_PAIR3) {
      pair3_frag(ws, ld, 4 * (c & 3) + s, t4, b);
    } else if constexpr (PART == 0) {  // 4-bit fields, plane c % 8 (< 4)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        b[h] = p4_reg((uint32_t)ws[(8 * s + 4 * h + t4) * ld], c & 7);
    } else {
      pair3_frag(ws, ld, 4 * ((c & 7) - 4) + s, t4, b);
    }
  }

  // The products of one 64-row chunk: sa at the warp's first A row (lane's
  // ldmatrix address), ws at its first column (lane's B column). SERIAL
  // keeps the k16 steps a loop, so their word loads are not all hoisted.
  template <int PART, int WM, int WN, bool SERIAL>
  static __device__ __forceinline__ void mma_steps(float (&acc)[WM][WN][4],
                                                   const bf16* sa,
                                                   const int* ws, int c,
                                                   int t4) {
    using T = MmaTile<WM, WN, WPAD>;
#pragma unroll (SERIAL ? 1 : MMA_KC / 16)
    for (int s = 0; s < MMA_KC / 16; ++s) {
      uint32_t a[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i)
        ldsm_x4(a[i], sa + i * 16 * T::A_LD + 16 * s);
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        uint32_t b[2];
        b_frag<PART>(ws + 8 * j, T::W_LD, c, s, t4, b);
#pragma unroll
        for (int i = 0; i < WM; ++i) mma_bf16(acc[i][j], a[i], b);
      }
    }
  }

  template <int WM, int WN, int MINB>
  static __device__ __forceinline__ void mma_chunk(float (&acc)[WM][WN][4],
                                                   const bf16* sa,
                                                   const int* ws, int c,
                                                   int t4, const uint32_t*) {
    // At two blocks an SM the pair3 decode's hoisted words would spill
    // past 128 registers: its steps stay a loop there (measured as fast).
    constexpr bool p3_serial = MINB == 2;
    if (KIND == TILE_PAIR3X && (c & 7) >= 4)
      mma_steps<1, WM, WN, p3_serial>(acc, sa, ws, c, t4);
    else
      mma_steps<0, WM, WN, p3_serial && KIND == TILE_PAIR3>(acc, sa, ws, c,
                                                            t4);
  }

  // Units of kw word rows (ops/dequant_matmul.py stream_units mirrors it).
  static __device__ __forceinline__ int stream_units(int kw) {
    if constexpr (KIND == TILE_PAIR) return kw / 8;
    else if constexpr (KIND == TILE_PAIR3) return kw / PG * 2;
    else return kw / PG * 6;
  }

  // The first K row of step s of unit u (a multiple of 16), or NO_ROW.
  static __device__ __forceinline__ int step_row(int u, int s) {
    if constexpr (KIND == TILE_PAIR) {
      const int w = 8 * u;
      return w / PG * BK + 2 * (w % PG) + s * 2 * PG;
    } else if constexpr (KIND == TILE_PAIR3) {
      return (u >> 1) * BK + 16 * (2 * s + (u & 1));
    } else {
      const int r = u % 6, k0 = u / 6 * BK;
      if (r < 4) return s < 4 ? k0 + 64 * s + 16 * r : NO_ROW;
      return k0 + 256 + 16 * (2 * s + r - 4);
    }
  }

  // The word rows lane t4 loads for unit u. Rows 0 and 1 give the lane's
  // A registers at k = 2*t4, +1 and k = 2*t4 + 8, +9 of every step: the K
  // rows 4*t4 .. 4*t4 + 3 of the step (the same permutation of k as its x
  // load). For the 3-bit rules rows 2 and 3 are the pair3 tile's high
  // words, -1 where the unit has none.
  static __device__ __forceinline__ void unit_rows(int u, int t4,
                                                   int (&r)[RW]) {
    if constexpr (KIND == TILE_PAIR) {
      r[0] = 8 * u + 2 * t4;
    } else if constexpr (KIND == TILE_PAIR3) {
      const int t = (u >> 1) * PG;
      r[0] = t + 8 * (u & 1) + 2 * t4;
      r[2] = t + 16 + 2 * t4;
    } else {
      const int q = u % 6, t = u / 6 * PG;
      r[0] = q < 4 ? t + 8 * q + 2 * t4 : t + 32 + 8 * (q - 4) + 2 * t4;
      r[2] = q < 4 ? -1 : t + 48 + 2 * t4;
    }
    r[1] = r[0] + 1;
    if constexpr (RW == 4) r[3] = r[2] < 0 ? -1 : r[2] + 1;
  }

  // The products of unit u: w[i][c] holds the lane's column c of its word
  // row i, x[s] its token's x at the K rows 4*t4 .. 4*t4 + 3 of step s.
  // m16 tile i takes its rows g and g + 8 from the lane's columns 2i and
  // 2i + 1. Steps at or past K are skipped (their x is 0; the words there
  // decode to nonzero weights).
  static __device__ __forceinline__ void stream_unit(
      float (&acc)[2][4], const uint32_t (&w)[RW][4],
      const uint32_t (&x)[STEPS][2], int u, int K, const uint32_t*) {
    if constexpr (KIND == TILE_PAIR) {
#pragma unroll
      for (int j = 0; j < HP; ++j) {
        if (step_row(u, j) >= K) break;  // the rows grow with the plane
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t a[4] = {pair_reg<NB>(w[0][2 * i], j),
                                 pair_reg<NB>(w[0][2 * i + 1], j),
                                 pair_reg<NB>(w[1][2 * i], j),
                                 pair_reg<NB>(w[1][2 * i + 1], j)};
          mma_bf16(acc[i], a, x[j]);
        }
      }
    } else {
      if (KIND == TILE_PAIR3X && u % 6 < 4) {
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
      const int hf = KIND == TILE_PAIR3 ? (u & 1) : u % 6 - 4;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (step_row(u, q) >= K) break;
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
};

template <int NB>
struct Pair : PairRule<TILE_PAIR, NB, (16 / NB % 2) ? 64 : 32,
                       2 * ((16 / NB % 2) ? 64 : 32) * (16 / NB)> {};
struct Pair3 : PairRule<TILE_PAIR3, 3, 24, 256> {};
struct Pair3x : PairRule<TILE_PAIR3X, 3, 56, 512> {};

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
