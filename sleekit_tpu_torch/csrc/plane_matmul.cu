// Kernels K8 and K9 of the port: dequantize + matmul over the 'plane'
// layout, on the two routes of dequant_routes.cuh under the 'plane' tile
// rules (Plane<NB, LUT>).
//
// Replaces:
//   K8  sleekit_tpu/ops/dequant_matmul.py  _pallas_impl / _kernel
//       (table codebooks: NF4, any k <= 2^nbits in any order; and 8-bit
//       affine codebooks)
//   K9  sleekit_tpu/ops/dequant_matmul.py  _pallas_impl / _mantissa_kernel
//       (affine codebooks, nbits <= 7: 1-4 in this layout)
// Layout: tiles of 32 word rows; word row g, field j (bits [nbits*j,
// +nbits)) holds the tile's K row j*32 + g; 32/nbits fields a word, 10 at
// 3 bits (320-row tiles). The TPU kernel's two-tile grid step at 3 bits is
// a TPU block rule, not part of the function.
//   K8  out = bf16((x @ bf16(v[idx])) * scale + bias), v = lut (0 past its
//       end) or, for an affine codebook, f32(idx)*step + zero
//   K9  out = bf16((a * (x @ (C - 1.5)) + b * rowsum(x)) * scale + bias),
//       C = 1 + idx/2^nbits, b the rowsum coefficient of the centred fold
// x (M, K) bf16, f32 accumulation; no prologue and no residual (the JAX
// kernels have none: the model composes the norm and activation around
// them), so the prologue pass copies x into xp and sums its rows.
//
// What bounds it on an H100: at decode (M = 8) the packed weight stream
// over device memory, as K1; at prefill M the products on the tensor
// cores.
//
// What the design does about it: K1's routes, with the plane layout's
// word geometry. Field j of 16 consecutive word rows of a tile is 16
// consecutive K rows, one k16 step, so one register of an m16n8k16
// fragment (two consecutive K rows of one column) is field j of two
// consecutive word rows, packed as bf16x2 (Plane::reg): K9 ORs each field
// under the bf16 exponent of 1.0 (C, exact) and takes off 1.5 in one
// exact bf16x2 FMA, as K1 does, so the fold does not cancel; K8 looks both
// values up in a table that every block fills in shared memory, already
// rounded to bf16 as the TPU kernel rounds it (a 32-bit entry holds the
// bf16 in both halves, one byte permute packs two), and passes a = 1,
// b = 0 to the epilogue. A table of at most 16 entries takes 16 banks, so
// a warp's lookups do not conflict; the 8-bit table's 256 can.
// - Tensor-core route: chunk c of a tile (64 K rows) is fields 2(c % CPT)
//   and + 1 of the tile's 32 word rows, so each chunk reads the tile's
//   words again (CPT = VPW/2 times a tile; from L2). Steps s and s + 2 of
//   a chunk read the same word rows, so one load of the words serves both:
//   one shared load per B register, as K1's.
// - Decode route: a unit is 16 word rows of one tile; lane t4 loads word
//   rows 4*t4 .. 4*t4 + 3 (RW = 4), which carry its K rows 4*t4 ..
//   4*t4 + 3 in every one of the unit's steps, one step per field (the
//   permutation of k of its 8-byte xp load). At 1 and 2 bits (32 and 16
//   fields) a unit takes 8 fields of its words, so that its x registers
//   stay within the kernel's 128 (its words are read again for the next
//   8, from L1).
#include "dequant_routes.cuh"

namespace {

constexpr int PLANE_ROWS = 32;  // word rows per plane tile

// K8's values: the table (ksize entries, 0 past them) or, with lut null,
// the 8-bit affine grid f32(idx)*step + zero. The kernels' own parameter
// (aux), not a field of Args.
struct Table {
  const float* lut;
  int ksize;
  float step, zero;
};

template <int NB, bool LUT>
struct Plane {
  static constexpr int VPW = NB == 3 ? 10 : 32 / NB;  // fields a word
  static constexpr int BK = PLANE_ROWS * VPW;         // K rows a tile
  static constexpr int CPT = VPW / 2;                 // 64-row chunks a tile
  // Word rows 2*t4 + c of a B load: rows 4 int32 apart in the banks.
  static constexpr int WPAD = 4;
  static constexpr int RW = 4;
  static constexpr int STEPS = VPW > 10 ? 8 : VPW;  // fields a unit
  static constexpr int SUB = VPW / STEPS;           // units a word row
  static_assert(VPW % 2 == 0 && VPW % STEPS == 0, "plane tile geometry");

  // K9 has no decoder state.
  static __device__ __forceinline__ const uint32_t* setup() { return nullptr; }

  // K8: the block's table in shared memory, entry i the bf16 of value i in
  // both halves.
  static __device__ __forceinline__ const uint32_t* setup(const Table& t) {
    __shared__ uint32_t tab[1 << NB];
    for (int i = threadIdx.x; i < (1 << NB); i += THREADS) {
      const float v =
          t.lut ? (i < t.ksize ? t.lut[i] : 0.0f)
                : __fadd_rn(__fmul_rn((float)i, t.step), t.zero);
      const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      tab[i] = b | b << 16;
    }
    __syncthreads();
    return tab;
  }

  // One bf16x2 register of the weight: field j of word w0 (low half, the
  // lower K row) and of word w1 (high half). K9: C - 1.5 (the field under
  // the exponent of 1.0, one shift a word, a byte permute, one AND-OR);
  // K8: the table's two values.
  static __device__ __forceinline__ uint32_t reg(uint32_t w0, uint32_t w1,
                                                 int j, const uint32_t* tab) {
    if constexpr (LUT) {
      constexpr uint32_t m = (1u << NB) - 1u;
      return __byte_perm(tab[(w0 >> (NB * j)) & m], tab[(w1 >> (NB * j)) & m],
                         0x7610);
    } else {
      constexpr uint32_t m = ((1u << NB) - 1u) << (7 - NB);
      const int sh = NB * j - (7 - NB);  // field j to bits [7 - NB, 7)
      const uint32_t a = sh >= 0 ? w0 >> sh : w0 << -sh;
      const uint32_t b = sh >= 0 ? w1 >> sh : w1 << -sh;
      return bf2_fma((__byte_perm(a, b, 0x5410) & (m | m << 16)) |
                         0x3F803F80u,
                     1.0f, -1.5f);
    }
  }

  // Chunk c reads all 32 word rows of its tile.
  static __device__ __forceinline__ int2 chunk_words(int c) {
    return make_int2(c / CPT * PLANE_ROWS, PLANE_ROWS);
  }

  // The products of 64-row chunk c: fields j0 = 2(c % CPT) (steps 0, 1)
  // and j0 + 1 (steps 2, 3). B register h of lane t4 at step s holds K rows
  // 8h + 2*t4 and + 1 of the step: field j0 + s/2 of word rows (s%2)*16 +
  // 8h + 2*t4 and + 1. So steps sp and sp + 2 read the same words: they
  // are loaded once for both (4 a column tile), and the A fragments of one
  // step at a time. sa and ws as in PairRule::mma_steps.
  template <int WM, int WN, int MINB>
  static __device__ __forceinline__ void mma_chunk(float (&acc)[WM][WN][4],
                                                   const bf16* sa,
                                                   const int* ws, int c,
                                                   int t4,
                                                   const uint32_t* tab) {
    using T = MmaTile<WM, WN, WPAD>;
    const int sh = NB * 2 * (c % CPT);  // field j0 to bit 0
#pragma unroll
    for (int sp = 0; sp < 2; ++sp) {  // steps sp and sp + 2
      uint32_t w[WN][2][2];
#pragma unroll
      for (int j = 0; j < WN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int* p = ws + (16 * sp + 8 * h + 2 * t4) * T::W_LD + 8 * j;
          w[j][h][0] = (uint32_t)p[0] >> sh;
          w[j][h][1] = (uint32_t)p[T::W_LD] >> sh;
        }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t a[WM][4];
#pragma unroll
        for (int i = 0; i < WM; ++i)
          ldsm_x4(a[i], sa + i * 16 * T::A_LD + 16 * (sp + 2 * q));
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          const uint32_t b[2] = {reg(w[j][0][0], w[j][0][1], q, tab),
                                 reg(w[j][1][0], w[j][1][1], q, tab)};
#pragma unroll
          for (int i = 0; i < WM; ++i) mma_bf16(acc[i][j], a[i], b);
        }
      }
    }
  }

  // Units of kw word rows: 16 word rows (half a tile) by STEPS fields
  // (ops/dequant_matmul.py stream_units mirrors it).
  static __device__ __forceinline__ int stream_units(int kw) {
    return kw / 16 * SUB;
  }

  // Unit u: half h = u/SUB % 2 of tile u/SUB/2, fields (u % SUB)*STEPS + s.
  static __device__ __forceinline__ int step_row(int u, int s) {
    const int q = u / SUB;
    return q / 2 * BK + 16 * (q % 2) + PLANE_ROWS * (u % SUB * STEPS + s);
  }

  static __device__ __forceinline__ void unit_rows(int u, int t4,
                                                   int (&r)[RW]) {
#pragma unroll
    for (int i = 0; i < RW; ++i) r[i] = u / SUB * 16 + 4 * t4 + i;
  }

  // The products of unit u: w[i][c] holds the lane's column c of word row
  // 4*t4 + i of the unit, its K row 4*t4 + i of every step; x[s] its
  // token's x at the K rows 4*t4 .. 4*t4 + 3 of step s. m16 tile i takes
  // its rows g and g + 8 from the lane's columns 2i and 2i + 1. Steps at or
  // past K are skipped (the last tile runs past K at 3 bits).
  static __device__ __forceinline__ void stream_unit(
      float (&acc)[2][4], const uint32_t (&w)[RW][4],
      const uint32_t (&x)[STEPS][2], int u, int K, const uint32_t* tab) {
    const int sh = NB * STEPS * (u % SUB);  // the unit's first field to bit 0
    uint32_t v[RW][4];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[r][c] = w[r][c] >> sh;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (step_row(u, s) >= K) break;  // the rows grow with the field
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c0 = 2 * i, c1 = 2 * i + 1;
        const uint32_t a[4] = {reg(v[0][c0], v[1][c0], s, tab),
                               reg(v[0][c1], v[1][c1], s, tab),
                               reg(v[2][c0], v[3][c0], s, tab),
                               reg(v[2][c1], v[3][c1], s, tab)};
        mma_bf16(acc[i], a, x[s]);
      }
    }
  }
};

Args plane_args(const void* x, const void* words, const void* scale,
                const void* bias, void* out, void* xp, void* rs, int M, int N,
                int K, int kw, float a, float b) {
  return pair_args(x, words, scale, bias, nullptr, nullptr, 0, nullptr, out,
                   xp, rs, M, N, K, K, kw, PRE_NONE, a, b, 0.0f);
}

}  // namespace

// K8. x (M, K) bf16; words (kw, N) int32 'plane', kw % 32 == 0; scale and
// bias (N,) f32 (bias may be null); lut (ksize,) f32 with ksize <= 2^nbits,
// or null for the affine grid f32(idx)*step + zero; out (M, N) bf16; xp,
// rs, part, tickets and splits the scratch and K split of K1's entry
// (pair_matmul), with splits from stream_plan over the plane units.
extern "C" int plane_lut_matmul(const void* x, const void* words,
                                const void* scale, const void* bias,
                                const void* lut, void* out, void* xp,
                                void* rs, void* part, void* tickets, int M,
                                int N, int K, int kw, int splits, int nbits,
                                int ksize, float step, float zero,
                                void* stream) {
  const Args g = plane_args(x, words, scale, bias, out, xp, rs, M, N, K, kw,
                            1.0f, 0.0f);
  const Split sp{static_cast<float*>(part), static_cast<int*>(tickets),
                 splits};
  const Table t{static_cast<const float*>(lut), ksize, step, zero};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return launch_pair_m<Plane<1, true>>(g, sp, s, t);
    case 2: return launch_pair_m<Plane<2, true>>(g, sp, s, t);
    case 3: return launch_pair_m<Plane<3, true>>(g, sp, s, t);
    case 4: return launch_pair_m<Plane<4, true>>(g, sp, s, t);
    case 8: return launch_pair_m<Plane<8, true>>(g, sp, s, t);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K9. Arguments as K8 without the table; a = step * 2^nbits and b the
// rowsum coefficient of the fold over C - 1.5 (zero + step/2).
extern "C" int plane_affine_matmul(const void* x, const void* words,
                                   const void* scale, const void* bias,
                                   void* out, void* xp, void* rs, void* part,
                                   void* tickets, int M, int N, int K, int kw,
                                   int splits, int nbits, float a, float b,
                                   void* stream) {
  const Args g = plane_args(x, words, scale, bias, out, xp, rs, M, N, K, kw,
                            a, b);
  const Split sp{static_cast<float*>(part), static_cast<int*>(tickets),
                 splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return launch_pair_m<Plane<1, false>>(g, sp, s);
    case 2: return launch_pair_m<Plane<2, false>>(g, sp, s);
    case 3: return launch_pair_m<Plane<3, false>>(g, sp, s);
    case 4: return launch_pair_m<Plane<4, false>>(g, sp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
