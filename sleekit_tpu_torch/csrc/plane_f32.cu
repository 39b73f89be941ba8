// Kernels K8f and K9f of the port: dequantize + matmul over the 'plane'
// layout at f32 activations, held to f32 accuracy: split-TF32 products on
// the tensor cores at every M, mma.sync at M <= 8, wgmma above.
//
// Replaces (x f32, where the JAX kernel's compute_dtype is f32):
//   K8f sleekit_tpu/ops/dequant_matmul.py  _pallas_impl / _kernel
//       (table codebooks: NF4, any k <= 2^nbits in any order; and 8-bit
//       affine codebooks)
//   K9f sleekit_tpu/ops/dequant_matmul.py  _pallas_impl / _mantissa_kernel
//       with the affine fold after it (affine codebooks, nbits <= 7: 1-4
//       in this layout)
// Layout: tiles of 32 word rows; word row g, field j (bits [nbits*j,
// +nbits)) holds the tile's K row j*32 + g; 32/nbits fields a word, 10 at
// 3 bits (320-row tiles).
//   K8f out = ((x @ v[idx]) * scale) + bias, v the f32 table (0 past its
//       end) or, for an affine codebook, f32(idx)*step + zero; nothing
//       is rounded to bf16
//   K9f out = (a * (x @ (C - 1.5)) + b * rowsum(x)) * scale + bias, C = 1 +
//       idx/2^nbits (C - 1.5 exact in f32), b the rowsum coefficient of
//       the centred fold (the JAX fold over C itself cancels when x has a
//       large mean)
// x (M, K) f32, out (M, N) f32; x counts as 0 at K rows past K (a zero
// word decodes to v[0], which need not be 0).
//
// What bounds it on an H100: at M <= 8 (decode) the packed weight stream
// over device memory (4 bits: 0.5 byte a weight against 2M operations);
// above, the operations. One TF32 product keeps about 3 decimal digits
// and misses the 1e-5 criteria, so an f32-accurate product takes either
// the CUDA cores (67 TFLOP/s) or three TF32 products on the tensor cores
// (two for K9f; 495 TFLOP/s dense, so 165 and 248 TFLOP/s of f32 work):
// the tensor cores bound it.
//
// What the design does about it:
// - Both routes split each operand into two TF32 values whose products on
//   the tensor cores sum to the f32 product: w_lo*x_hi + w_hi*x_lo, then
//   w_hi*x_hi (K9f's C - 1.5 is exact in TF32: without w_lo); w_lo*x_lo
//   (about 2^-21 of it) is dropped. The tensor cores align a sum's terms
//   to the largest, truncate each 25 bits below it and truncate the sum
//   to f32 (tests/test_torch_cuda.py test_tf32_mma_truncates), a bias
//   towards zero of up to one f32 step an instruction: over fc2's K = 8192
//   in one chain, 5e-5 to 8e-5 of the largest output with x >= 0
//   (tests/test_torch_plane_f32.py). So every chain is short: fresh
//   fragments, then added into f32 accumulators with __fadd_rn.
// - Streaming route (M <= 8), stream_tf32_kernel: the operands swap, as
//   in K1's decode route (dequant_routes.cuh): the decoded weight is the
//   A operand of mma.sync m16n8k8 TF32 (16 columns by 8 K rows) and the
//   tokens the n8 B operand (its columns past M zero). K order inside a k8
//   step is free where A and B share it: step s of a unit is field s of 8
//   consecutive word rows (8 consecutive K rows), and lane (g, t) holds K
//   rows 2t and 2t + 1 of it, so its A registers come straight from the
//   two word rows it loaded (16 bytes of each: 4 columns, so a warp's load
//   of a row is 128 consecutive bytes) and its B registers from one 8-byte
//   load of x. Every word serves all its fields: a unit is 8 word rows by
//   all of a word's fields (8 at 1 and 2 bits, whose words load again for
//   the rest, from L1). A weight's hi is its value itself (the tensor
//   cores read its top 19 bits) and lo the rest (2 operations); K8f takes
//   the value from an f32 table in shared memory (2 integer operations and
//   a 4-byte lookup; a (hi, lo) table's 8-byte lookups measured no faster
//   on the card), K9f builds C - 1.5 under the exponent of 1.0 (3
//   operations). x's hi is the nearest TF32 (cvt.rna.tf32's value,
//   by integer rounding of the bits) and lo = x - hi (centred: no bias).
//   At M <= 4 (TOK = 4) x's hi fills columns 0-3 of the n8 and its lo
//   columns 4-7, so one mma forms both of a weight part's products with x
//   (K8f 2 mma a k8 step, K9f 1; at TOK = 8, 3 and 2); the hi and lo
//   columns meet at the end. Each kind of product sums in a fragment of
//   its own, fresh each unit (8 k8 steps at 4 bits), then into f32
//   accumulators. A block is a 32-column strip (two m16 tiles a warp; a
//   strip of one tile measured no faster on the card) over a K slice
//   split over its warps, each with the next unit's words and x in flight
//   in registers while this unit's products run; the warps' sums meet in
//   shared memory in warp order. Where the strips alone leave SMs idle
//   (o and fc2 of OPT-1.3B: 64 strips) K is split over blocks too
//   (ops/dequant_matmul.py f32_stream_plan: a power of two, at most 8,
//   keeping the blocks within one an SM, so that all of a launch's
//   clusters are resident at once; then 16 warps a block), and a strip's
//   splits form one thread block cluster along K: each
//   block stores its sums into the first block's shared memory and
//   arrives at a cluster barrier; the first alone waits, adds them in
//   rank order and finishes. No partials go to device memory and no
//   ticket or fence is needed, so every run of a call gives the same
//   bits, eager or replayed in a CUDA graph. Each launch is the
//   programmatic dependent of the kernel before it: it starts, and loads
//   its words, table, scale and bias (the layer's constants), while that
//   kernel ends, and waits for it (griddepcontrol.wait) before it reads x
//   or writes.
//   What bounds it on the card (PERF.md): not the bytes (the four
//   projections take several times their bytes bound); timed ablations
//   put it in the decode's instruction issue (about 60 instructions a
//   warp's k8 step of 256 weights) and each launch's fixed cost, not in
//   the loads or the number of mma.
// - Tiled route (M > 8), f32_tile_kernel: wgmma (m64 n128 k8)
//   TF32 on split operands, both from shared memory, K-major, with the
//   128-byte swizzle (a step's 32 K rows are one 128-byte row); x is
//   staged as it comes and the tensor cores read its top 19 bits (hi = v
//   truncated), beside lo = cvt.rna.tf32(v - hi) from that same hi: hi +
//   lo is within 2^-21 |v|. The fragment starts afresh every TILE_CHAIN =
//   4 steps (48 wgmma of 8 K, 32 for K9f; 1.4e-6 of the largest output in
//   the emulation, test_tile_chain_holds_1e5).
//   Tile and grid: 128 x 128 outputs a block (64 rows a consumer
//   warpgroup, wgmma m64 n128 k8), and a K split over blocks with the
//   streaming route's self-resetting tickets where that finishes first
//   (ops/dequant_matmul.py f32_tile_plan). A step is 32 consecutive K
//   rows, one field of a plane tile's 32 word rows.
//   Warp specialization, 512 threads: warpgroups 0 and 1 produce, with 96
//   registers (setmaxnreg): per step they load x from device memory into
//   registers a step ahead (16-byte loads where K and the pointer allow),
//   store it and its lo into the stage, and decode the plane tile's words
//   (kept in registers from its first step) into the weight's hi and lo,
//   each x element and weight once a block; then fence.proxy.async and
//   arrive at the stage's FULL barrier. Warpgroups 2 and 3 consume, with
//   160 registers: at FULL they issue the step's 12 wgmma (K9f 8) behind
//   the previous step's, wait for that one, and free its stage (EMPTY).
//   A ring of three stages (named barriers, no atomics) lets the
//   producers stage step st + 1 while the tensor cores run step st. The
//   stores into the swizzled tiles hit distinct banks (lanes on
//   consecutive rows or chunks). Shared memory: 198,288 bytes for K8f's
//   NF4 (149,072 for K9f); ptxas: 128 registers a thread at launch, no
//   spills.
// - K9f's row sums are summed in f32 on the CUDA cores inside the launch
//   in a fixed order: at M <= 8 by the lanes that load x (a step's pair, a
//   unit's steps, Kahan over the units; then the lanes of a token, the
//   warps and the cluster's ranks in order), above by the producers (4
//   values pairwise, over a row's 8 lanes, Kahan over the steps). The
//   epilogue applies a, b, scale and bias and writes f32.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NWARPS = 8;  // a streaming block's warps, twice that where K
                           // splits
constexpr int PLANE_ROWS = 32;  // word rows per plane tile
constexpr int TILES = 2;        // streaming route: m16 tiles a warp
constexpr int COLS = 16 * TILES, CPL = 2 * TILES;  // a strip's, a lane's
constexpr int UNIT_ROWS = 8;    // streaming route: word rows a unit
constexpr int MAX_CLUSTER = 8;  // streaming route: K splits at most
constexpr int TILE_M = 128;      // tiled route's block rows: 64 a consumer
constexpr int TILE_N = 128;      // and columns
constexpr int PRODUCERS = 256;   // tiled route: warpgroups 0, 1 stage
constexpr int TILE_THREADS = 2 * PRODUCERS;  // and 2, 3 consume
constexpr int PRODUCER_REGS = 96, CONSUMER_REGS = 160;  // setmaxnreg
constexpr int TILE_CHAIN = 4;    // steps a wgmma fragment sums
constexpr int BAR_ROWS = 7, BAR_CONSUMERS = 8;  // named barrier ids

struct Args {
  const float* x;
  const int* w;
  const float* scale;
  const float* bias;
  float* out;
  int M, N, K, kw;
  float a, b;  // K9f: out = (a*acc + b*rowsum)*scale + bias
};

// The tiled route's K split over blocks: splits slices, and above one the
// partial sums (splits, M, N), then K9f's partial row sums (splits, strips
// of 128 columns, M), and one ticket per tile, 0 between launches.
struct Split {
  float* part;
  int* tickets;
  int splits;
};

// K8f's values: the table (ksize entries, 0 past them) or, with lut null,
// the 8-bit affine grid f32(idx)*step + zero.
struct Table {
  const float* lut;
  int ksize;
  float step, zero;
};

// v as hi + lo, two TF32 values: lo is v - hi (exact) rounded, so hi + lo
// is within 2^-22 |v| of v.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// x as hi + lo for the streaming route's B operand: hi the nearest TF32
// (cvt.rna.tf32's value: the bits rounded half away from zero at bit 13),
// lo = x - hi, exact in f32 and centred on 0 (the tensor cores read its
// top 19 bits).
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// v - hi, hi the top 19 bits of v (the TF32 value the tensor cores read
// of it): exact in f32, at most 13 significant bits, of v's sign.
__device__ __forceinline__ float low_part(float v) {
  return __fsub_rn(v, __uint_as_float(__float_as_uint(v) & 0xFFFFE000u));
}

template <int NB, bool LUT>
struct Rule {
  static constexpr int VPW = NB == 3 ? 10 : 32 / NB;  // fields a word
  static constexpr int BK = PLANE_ROWS * VPW;         // K rows a tile
  static constexpr uint32_t MASK = (1u << NB) - 1u;
  // Streaming route: a unit is UNIT_ROWS word rows of a tile by STEPS of
  // their fields (one k8 step each), SUB units a row group.
  static constexpr int STEPS = VPW > 10 ? 8 : VPW;
  static constexpr int SUB = VPW / STEPS;
  static_assert(VPW % STEPS == 0 && PLANE_ROWS % UNIT_ROWS == 0,
                "plane tile geometry");
  static_assert(LUT || NB <= 10, "C - 1.5 is exact in TF32");

  // K8f's value of index i: the table's (0 past ksize) or the 8-bit grid's
  // as the plain version computes it (a product, then a sum, each
  // rounded).
  static __device__ __forceinline__ float lut_value(const Table& t, int i) {
    return t.lut ? (i < t.ksize ? __ldg(t.lut + i) : 0.0f)
                 : __fadd_rn(__fmul_rn((float)i, t.step), t.zero);
  }

  // The streaming route's table: K8f's values, f32 as given. Every thread
  // of the block calls it.
  static __device__ __forceinline__ void setup(float* tab, const Table& t) {
    for (int i = threadIdx.x; i < (1 << NB); i += blockDim.x)
      tab[i] = lut_value(t, i);
    __syncthreads();
  }

  // The tiled route's table: K8f's values split, (hi, lo) a value; K9f's
  // C - 1.5 (idx/2^NB - 1/2: at most NB significant bits, exact in TF32,
  // so its lo is 0). Every thread of the block calls it.
  static __device__ __forceinline__ void split_setup(float* tab,
                                                     const Table& t) {
    for (int i = threadIdx.x; i < (1 << NB); i += blockDim.x) {
      if constexpr (LUT) {
        uint32_t hi, lo;
        split_tf32(lut_value(t, i), hi, lo);
        tab[2 * i] = __uint_as_float(hi);
        tab[2 * i + 1] = __uint_as_float(lo);
      } else {
        tab[i] = __fsub_rn(__fmul_rn((float)i, 1.0f / (1 << NB)), 0.5f);
      }
    }
    __syncthreads();
  }

  // Streaming route: field s of word v as an A register's hi and lo (hi
  // the value itself: the tensor cores read its top 19 bits). K8f: the
  // field times 4 (2 integer operations) is the byte offset of its value
  // in the table, and lo its low part (2 operations; a (v, lo) table's
  // 8-byte lookups measured no faster on the card); K9f: C - 1.5, the
  // field under the exponent of 1.0 (2 operations) minus 1.5 (exact in
  // TF32; lo 0, unused).
  static __device__ __forceinline__ void weight(uint32_t v, int s,
                                                const float* tab,
                                                uint32_t& hi, uint32_t& lo) {
    const int p = NB * s;  // a constant where the steps unroll
    if constexpr (LUT) {
      const float e = *reinterpret_cast<const float*>(
          reinterpret_cast<const char*>(tab) +
          ((p >= 2 ? v >> (p - 2) : v << (2 - p)) & (MASK << 2)));
      hi = __float_as_uint(e);
      lo = __float_as_uint(low_part(e));
    } else {
      constexpr int Q = 23 - NB;  // the field's place under the exponent
      const uint32_t c =
          ((p >= Q ? v >> (p - Q) : v << (Q - p)) & (MASK << Q)) |
          0x3F800000u;
      hi = __float_as_uint(__fsub_rn(__uint_as_float(c), 1.5f));
      lo = 0u;
    }
  }
};

// An output from its column's sum s (and K9f's row sum r), the column's
// scale sc and bias bi.
template <bool LUT>
__device__ __forceinline__ float value_out(const Args& g, float s, float r,
                                           float sc, float bi) {
  float y = LUT ? __fmul_rn(s, sc)
                : __fmul_rn(__fadd_rn(__fmul_rn(g.a, s), __fmul_rn(g.b, r)),
                            sc);
  return g.bias ? __fadd_rn(y, bi) : y;
}

// s += v with Kahan's compensation c (K9f's row sums).
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// The streaming route at M <= TOK (4 or 8): block (x, y) takes the
// COLS-column strip x over K slice y of gridDim.y (units in equal shares),
// split again over its warps; the gridDim.y blocks of a strip form a
// cluster along K. Lane (g, t) holds columns CPL g .. CPL g + CPL - 1 of
// the strip and, of every k8 step, K rows 2t and 2t + 1 (word rows 2t, 2t
// + 1 of the unit) and the n8 column g: at TOK = 8 token g's x as hi and
// lo; at TOK = 4 token g % 4's x hi (g < 4) or lo (g >= 4), so that one
// mma forms both of a weight part's products with x. Tile i takes its rows
// g and g + 8 from the lane's columns 2i and 2i + 1. A block has NWARPS
// warps, or twice as many where K splits (then the blocks are at most one
// an SM); either way at most 128 registers a thread.
template <int NB, bool LUT, int TOK>
__global__ void __launch_bounds__(64 * NWARPS, 1)
    stream_tf32_kernel(Args g, Table t) {
  using R = Rule<NB, LUT>;
  constexpr int ST = R::STEPS;
  __shared__ float tab[LUT ? 1 << NB : 1];
  __shared__ float red[2 * NWARPS][8][COLS];
  __shared__ float rsw[2 * NWARPS][8];
  // The first rank's: every rank's sums, written through distributed
  // shared memory.
  __shared__ float sums[MAX_CLUSTER][8][COLS];
  __shared__ float rows[MAX_CLUSTER][8];
  // A kernel launched after this one as its programmatic dependent may
  // start now: it waits for this grid before it reads x or writes. Where
  // K splits, this block arrives at the cluster's first barrier phase:
  // waited for at the end, it shows that every block of the cluster has
  // started before any writes into another's shared memory.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  if (gridDim.y > 1)
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = blockDim.x / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * COLS, n = n0 + CPL * gq;
  const bool vec = g.N % CPL == 0 &&
                   (reinterpret_cast<uintptr_t>(g.w) & (4 * CPL - 1)) == 0;
  const bool xvec = g.K % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(g.x) & 7) == 0;
  const int splits = gridDim.y;
  const int units = g.kw / UNIT_ROWS * R::SUB;
  const int b0 = units * blockIdx.y / splits;
  const int b1 = units * (blockIdx.y + 1) / splits;
  const int u0 = b0 + (b1 - b0) * warp / nw;
  const int u1 = b0 + (b1 - b0) * (warp + 1) / nw;
  // The lane's token, whether it passes x's lo (TOK = 4, g >= 4) and
  // whether its x counts in K9f's row sums (once a token).
  const int token = gq % TOK;
  const bool lo_half = TOK == 4 && gq >= 4;
  const bool tok = token < g.M;
  const bool counts = tok && !lo_half;
  const float* xrow = g.x + (size_t)(tok ? token : 0) * g.K;
  // The epilogue's thread, one of the first 8 x COLS: token m, column c of
  // the strip; its scale and bias load now.
  const int m = tid / COLS % 8, c = tid % COLS, nn = n0 + c;
  const bool out = tid < 8 * COLS;
  const bool mine = out && m < g.M && nn < g.N;
  const float sc = mine ? __ldg(g.scale + nn) : 0.0f;
  const float bi = mine && g.bias ? __ldg(g.bias + nn) : 0.0f;

  // First K row of step s of unit u: field (u % SUB)*STEPS + s of the
  // unit's 8 word rows, in its tile.
  const auto step_row = [&](int u, int s) {
    const int q = u / R::SUB;  // the unit's row group
    return q / (PLANE_ROWS / UNIT_ROWS) * R::BK +
           PLANE_ROWS * (u % R::SUB * ST + s) +
           UNIT_ROWS * (q % (PLANE_ROWS / UNIT_ROWS));
  };
  // The lane's CPL columns of the unit's word rows 2t, 2t + 1: one 16-byte
  // load a row where vec, else 4-byte ones; zeros past N.
  static_assert(CPL == 4, "a lane's columns are one 16-byte load");
  const auto load_w = [&](int u, uint32_t (&w)[2][CPL]) {
    const int r = u / R::SUB * UNIT_ROWS + 2 * t4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int* p = g.w + (size_t)(r + i) * g.N + n;
      if (vec) {
        uint4 q = make_uint4(0u, 0u, 0u, 0u);
        if (n < g.N) q = __ldg(reinterpret_cast<const uint4*>(p));
        w[i][0] = q.x;
        w[i][1] = q.y;
        w[i][2] = q.z;
        w[i][3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < CPL; ++e)
          w[i][e] = n + e < g.N ? (uint32_t)__ldg(p + e) : 0u;
      }
    }
  };
  const auto load_x = [&](int u, float (&x)[ST][2]) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      const int k = step_row(u, s) + 2 * t4;
      float2 v = make_float2(0.0f, 0.0f);
      if (tok && k < g.K) {
        if (xvec) {
          v = __ldg(reinterpret_cast<const float2*>(xrow + k));
        } else {
          v.x = __ldg(xrow + k);
          if (k + 1 < g.K) v.y = __ldg(xrow + k + 1);
        }
      }
      x[s][0] = v.x;
      x[s][1] = v.y;
    }
  };

  // A ring of two units in registers: unit u0 + v in buffer v % 2, and
  // unit u + 1 loads while the products of unit u run. The words, the
  // table, scale and bias do not depend on the kernel launched before
  // this one on the stream (of which it is the programmatic dependent);
  // x does, and every write comes after x.
  uint32_t w[2][2][CPL];
  float x[2][ST][2];
  if (u0 < u1) load_w(u0, w[0]);
  if constexpr (LUT) R::setup(tab, t);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (u0 < u1) load_x(u0, x[0]);

  float acc[TILES][4];
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  float rs = 0.0f, rc = 0.0f;  // K9f: the lane's x, Kahan over the units

  // The products of unit u, each kind in a fragment of its own, fresh
  // each unit, so a tile has P independent mma chains of ST steps; at the
  // end the small kinds, then the largest, are added into acc. TOK = 8:
  // f[P - 1] w_hi*x_hi, f[P - 2] w_hi*x_lo and, for K8f, f[0] w_lo*x_hi;
  // TOK = 4: f[P - 1] w_hi*x and, for K8f, f[0] w_lo*x, each x hi in
  // columns 0-3 and lo in 4-7. Steps at or past K meet x = 0 and add
  // nothing.
  constexpr int P = (LUT ? 2 : 1) + (TOK == 8 ? 1 : 0);
  const auto unit = [&](int u, const uint32_t (&wu)[2][CPL],
                        const float (&xu)[ST][2]) {
    const int sh = NB * ST * (u % R::SUB);  // the unit's first field
    uint32_t v[2][CPL];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < CPL; ++e) v[r][e] = wu[r][e] >> sh;
    float f[TILES][P][4];
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[i][p][e] = 0.0f;
    float us = 0.0f;
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      uint32_t bh[2], bl[2];
      split_rn(xu[s][0], bh[0], bl[0]);
      split_rn(xu[s][1], bh[1], bl[1]);
      if (TOK == 4 && lo_half) {  // this lane's n8 column is x's lo
        bh[0] = bl[0];
        bh[1] = bl[1];
      }
      if constexpr (!LUT) us = __fadd_rn(us, __fadd_rn(xu[s][0], xu[s][1]));
#pragma unroll
      for (int i = 0; i < TILES; ++i) {
        const uint32_t wv[4] = {v[0][2 * i], v[0][2 * i + 1], v[1][2 * i],
                                v[1][2 * i + 1]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) R::weight(wv[e], s, tab, ah[e], al[e]);
        if constexpr (LUT) mma_tf32(f[i][0], al, bh[0], bh[1]);
        if constexpr (TOK == 8) mma_tf32(f[i][P - 2], ah, bl[0], bl[1]);
        mma_tf32(f[i][P - 1], ah, bh[0], bh[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float small = 0.0f;
#pragma unroll
        for (int p = 0; p < P - 1; ++p)
          small = p ? __fadd_rn(small, f[i][p][e]) : f[i][p][e];
        acc[i][e] = __fadd_rn(
            acc[i][e], P > 1 ? __fadd_rn(small, f[i][P - 1][e])
                             : f[i][P - 1][e]);
      }
    if constexpr (!LUT) {
      if (counts) kahan_add(rs, rc, us);
    }
  };
  for (int u = u0; u < u1; u += 2) {
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      if (u + d + 1 < u1) {
        load_w(u + d + 1, w[1 - d]);
        load_x(u + d + 1, x[1 - d]);
      }
      if (u + d < u1) unit(u + d, w[d], x[d]);
    }
  }
  if constexpr (TOK == 4) {
    // Column 2t + e of lane t >= 2 holds token 2t + e - 4's products with
    // x's lo: the hi and lo sums of tokens 0-3 meet in lanes t < 2.
#pragma unroll
    for (int i = 0; i < TILES; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][e] = __fadd_rn(acc[i][e],
                              __shfl_xor_sync(0xffffffffu, acc[i][e], 2));
  }

  // acc[i][e]: the lane's column 2i + e / 2, token 2t + e % 2.
#pragma unroll
  for (int i = 0; i < TILES; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[warp][2 * t4 + e % 2][CPL * gq + 2 * i + e / 2] = acc[i][e];
  if constexpr (!LUT) {
    // The 4 lanes of token g, in a fixed order.
    rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 1));
    rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, 2));
    if (t4 == 0) rsw[warp][gq] = rs;
  }
  __syncthreads();
  float sum = 0.0f, row = 0.0f;
  for (int wi = 0; wi < nw; ++wi) {
    sum += red[wi][m][c];
    if constexpr (!LUT) row += rsw[wi][m];
  }
  const auto finish = [&](float s2, float r2) {
    g.out[(size_t)m * g.N + nn] = value_out<LUT>(g, s2, r2, sc, bi);
  };
  if (splits == 1) {
    if (mine) finish(sum, row);
    return;
  }
  // The cluster's blocks (one a K slice) write their sums into the first
  // one's shared memory and arrive; the first alone waits, then adds them
  // in rank order and finishes. The others do not wait: nothing reads
  // their shared memory.
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (out) {
    *cluster.map_shared_rank(&sums[rank][m][c], 0) = sum;
    if (!LUT && c == 0) *cluster.map_shared_rank(&rows[rank][m], 0) = row;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (mine) {
    float s2 = 0.0f, r2 = 0.0f;
    for (int y = 0; y < splits; ++y) {
      s2 += sums[y][m][c];
      if constexpr (!LUT) r2 += rows[y][m];
    }
    finish(s2, r2);
  }
}

// The tiled route's shared memory (floats): a ring of NS stages, each the
// tiles of one step (32 K a row) in wgmma's K-major layout with the
// 128-byte swizzle: x as it comes (the tensor cores read its top 19 bits:
// hi) and x's lo, TILE_M rows each; the weight's halves, decoded (hi and,
// for K8f, lo), TILE_N rows n. Then the table (K8f: hi, lo a value; K9f: C -
// 1.5), K9f's row sums and the last-block flag; 1 KB more aligns the ring.
template <int NB, bool LUT>
struct Tile {
  static constexpr int ACC = TILE_N / 2;       // accumulators a thread
  static constexpr int XT = TILE_M * PLANE_ROWS;  // one x tile
  static constexpr int BT = TILE_N * PLANE_ROWS;  // one weight tile
  static constexpr int HALVES = LUT ? 2 : 1;   // weight tiles a step
  static constexpr int STAGE = 2 * XT + HALVES * BT;
  static constexpr int NS = 3;                 // stages in the ring
  static constexpr int XC = TILE_M * 8 / PRODUCERS;  // x chunks a producer
  static constexpr int TAB = HALVES << NB;
  static constexpr int SMEM = 4 * (NS * STAGE + TAB + TILE_M + 4) + 1024;
  static_assert(TILE_M == 128, "two consumer warpgroups of 64 rows");
  static_assert(2 * TILE_N == PRODUCERS, "two producers a column");
  static_assert((PRODUCER_REGS + CONSUMER_REGS) * PRODUCERS <= 65536,
                "the registers of one block an SM");
  static_assert(LUT || NB <= 11, "C - 1.5 is exact in TF32");
  static_assert(SMEM <= 232448, "an H100 block's shared memory");
  static_assert(2 * NS < BAR_ROWS, "FULL and EMPTY ids below BAR_ROWS");
};

// Float (r, k) of a K-major tile of 32 K a row with the 128-byte swizzle:
// rows of 128 bytes, 16-byte chunk k / 4 of row r at chunk (k / 4) ^ (r %
// 8); 8-row atoms of 1024 bytes.
__device__ __forceinline__ int swz(int r, int k) {
  return r * PLANE_ROWS + ((k / 4) ^ (r % 8)) * 4 + k % 4;
}

// The wgmma descriptor of 8 K columns of such a tile from p (1024-byte
// aligned atoms; p advances 32 bytes a k8 within them): the 128-byte
// swizzle, the 8-row atoms 1024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t swz_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared memory written by this thread is visible to wgmma (the async
// proxy) after the next barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the reads of d after the wait that precedes it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (= or +=) A B over a 64 x 128 x 8 tile of one warpgroup, TF32
// operands from shared memory by descriptor, f32 accumulator:
// acc 0 starts d afresh.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// A lane's 8 outputs of a row, v[2j + c] at column n + 8j + c: pairs of
// 8 bytes where vec, else element by element below N.
__device__ __forceinline__ void put8(float* p, int n, int N, bool vec,
                                     const float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n + 8 * j;
    if (vec) {
      if (c < N)
        *reinterpret_cast<float2*>(p + c) = make_float2(v[2 * j],
                                                        v[2 * j + 1]);
    } else {
      if (c < N) p[c] = v[2 * j];
      if (c + 1 < N) p[c + 1] = v[2 * j + 1];
    }
  }
}

// v += the same 8 places of row p, read past L1.
__device__ __forceinline__ void add8(const float* p, int n, int N, bool vec,
                                     float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n + 8 * j;
    if (vec) {
      if (c < N) {
        const float2 q = __ldcg(reinterpret_cast<const float2*>(p + c));
        v[2 * j] += q.x;
        v[2 * j + 1] += q.y;
      }
    } else {
      if (c < N) v[2 * j] += __ldcg(p + c);
      if (c + 1 < N) v[2 * j + 1] += __ldcg(p + c + 1);
    }
  }
}

// Named barriers (ids 1 ..; 0 is __syncthreads), over the block's threads
// or ``n`` of them: FULL s and EMPTY s of the ring, K9f's row sums, the
// consumers alone.
__device__ __forceinline__ void bar_sync(int id, int n = TILE_THREADS) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(TILE_THREADS)
               : "memory");
}

// The tiled route at M > 8: block (x, y, z) computes out[128 y .., 128 x ..]
// over K split z of sp.splits (steps in equal shares). Step st is K rows
// 32 st .. 32 st + 31: field st % VPW of plane tile st / VPW. Warpgroups
// 0 and 1 produce (with PRODUCER_REGS registers): for each step they fill
// a stage of the ring (x from device memory through registers, one step
// ahead, written as it is and as its lo; the words decoded by one table
// lookup into the weight's halves) and arrive at the stage's FULL
// barrier, once the consumers freed it (EMPTY). Warpgroups 2 and 3
// consume (with CONSUMER_REGS), rows 64 c .. 64 c + 63 each: a step's 4 x
// 3 wgmma (K9f 4 x 2)
// go out behind the previous step's, whose stage they then free; every
// TILE_CHAIN steps the fragment's sums are added into the accumulators.
template <int NB, bool LUT>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    f32_tile_kernel(Args g, Split sp, Table t) {
  using R = Rule<NB, LUT>;
  using T = Tile<NB, LUT>;
  constexpr int NS = T::NS;
  extern __shared__ __align__(16) float smem_raw[];
  float* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023) / 4;
  float* tab = ring + NS * T::STAGE;
  float* rsum = tab + T::TAB;
  int& last = *reinterpret_cast<int*>(rsum + TILE_M);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // The warpgroup, broadcast so that the compiler knows it is the same
  // across a warp (else it serializes the wgmma of a role's branch).
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;
  R::split_setup(tab, t);

  // The steps that hold K rows below K, and this block's share of them.
  const int steps = min(g.kw / PLANE_ROWS * R::VPW,
                        (g.K + PLANE_ROWS - 1) / PLANE_ROWS);
  const int st0 = steps * blockIdx.z / sp.splits;
  const int st1 = steps * (blockIdx.z + 1) / sp.splits;

  if (wg < 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // Producer thread tid: x chunks (rows tid / 8 + 32 i, 16-byte chunk
    // tid % 8: 8 lanes a 128-byte row, coalesced, and distinct banks in
    // the swizzled tiles); the weight's column n0 + tid % TILE_N, K rows
    // 16 (tid / TILE_N) .. + 15.
    const bool xvec = g.K % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(g.x) & 15) == 0;
    const int kc = tid % 8;
    float4 xc[T::XC], xn[T::XC];
    const auto load_x = [&](int st, float4 (&v)[T::XC]) {
#pragma unroll
      for (int i = 0; i < T::XC; ++i) {
        const int m = m0 + tid / 8 + 32 * i, k = st * PLANE_ROWS + 4 * kc;
        const float* p = g.x + (size_t)m * g.K + k;
        if (m >= g.M || k >= g.K) {
          v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else if (xvec) {
          v[i] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v[i] = make_float4(p[0], k + 1 < g.K ? p[1] : 0.0f,
                             k + 2 < g.K ? p[2] : 0.0f,
                             k + 3 < g.K ? p[3] : 0.0f);
        }
      }
    };
    constexpr int WR = PLANE_ROWS / 2;  // word rows a producer decodes
    const int wn = tid % TILE_N, g0 = tid / TILE_N * WR;
    uint32_t wreg[WR];  // the plane tile's words of them
    float rs[T::XC], rc[T::XC];  // K9f: Kahan sums of rows tid / 8 + 32 i
#pragma unroll
    for (int i = 0; i < T::XC; ++i) rs[i] = rc[i] = 0.0f;
    if (st0 < st1) load_x(st0, xc);
    for (int st = st0; st < st1; ++st) {
      if (st + 1 < st1) load_x(st + 1, xn);
      if (st >= st0 + NS) bar_sync(1 + NS + st % NS);  // stage st % NS free
      if (st == st0 || st % R::VPW == 0) {
        const int n = n0 + wn;
        const int* w =
            g.w + ((size_t)(st / R::VPW) * PLANE_ROWS + g0) * g.N + n;
#pragma unroll
        for (int r = 0; r < WR; ++r)
          wreg[r] = n < g.N ? (uint32_t)__ldg(w + (size_t)r * g.N) : 0u;
      }
      float* xh = ring + st % NS * T::STAGE;
      float* xl = xh + T::XT;
      float* bh = xl + T::XT;
#pragma unroll
      for (int i = 0; i < T::XC; ++i) {
        const int o = swz(tid / 8 + 32 * i, 4 * kc);
        const float v[4] = {xc[i].x, xc[i].y, xc[i].z, xc[i].w};
        uint32_t l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          l[e] = tf32_rna(__fsub_rn(
              v[e], __uint_as_float(__float_as_uint(v[e]) & 0xFFFFE000u)));
        *reinterpret_cast<float4*>(xh + o) = xc[i];
        *reinterpret_cast<uint4*>(xl + o) = make_uint4(l[0], l[1], l[2], l[3]);
        if constexpr (!LUT) {
          // The row's step sum: pairwise in the lane, then over the 8
          // lanes of the row in a fixed order (xor 1, 2, 4).
          float part = __fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3]));
#pragma unroll
          for (int o8 = 1; o8 < 8; o8 *= 2)
            part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o8));
          kahan_add(rs[i], rc[i], part);
        }
      }
      const int sh = NB * (st % R::VPW);
#pragma unroll
      for (int q = 0; q < WR / 4; ++q) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t idx = (wreg[4 * q + e] >> sh) & R::MASK;
          if constexpr (LUT) {
            const float2 v = reinterpret_cast<const float2*>(tab)[idx];
            h[e] = __float_as_uint(v.x);
            l[e] = __float_as_uint(v.y);
          } else {
            h[e] = __float_as_uint(tab[idx]);
          }
        }
        const int o = swz(wn, g0 + 4 * q);
        *reinterpret_cast<uint4*>(bh + o) = make_uint4(h[0], h[1], h[2], h[3]);
        if constexpr (LUT)
          *reinterpret_cast<uint4*>(bh + T::BT + o) =
              make_uint4(l[0], l[1], l[2], l[3]);
      }
      fence_async_smem();
      bar_arrive(1 + st % NS);  // stage st % NS full
#pragma unroll
      for (int i = 0; i < T::XC; ++i) xc[i] = xn[i];
    }
    if constexpr (!LUT) {
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < T::XC; ++i) rsum[tid / 8 + 32 * i] = rs[i];
      }
    }
    bar_arrive(BAR_ROWS);  // K9f's row sums written
    return;
  }

  // Consumer warpgroup c = wg - 2 (thread ct of the consumers): its rows
  // and columns in the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ct = tid - PRODUCERS, c = wg - 2;
  const int lane_g = lane / 4, tig = lane % 4;
  const int gm0 = 64 * c;
  float acc[T::ACC], frag[T::ACC];
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) acc[i] = frag[i] = 0.0f;
  for (int st = st0; st < st1; ++st) {
    bar_sync(1 + st % NS);  // stage st % NS full
    // Per 8 K, lo*hi and hi*lo, then hi*hi, into the fragment, which
    // starts afresh every TILE_CHAIN steps: the tensor cores truncate
    // each wgmma's sum, so a chain is 4 TILE_CHAIN x 3 wgmma (K9f x 2).
    const bool fresh = (st - st0) % TILE_CHAIN == 0;
    const float* xh = ring + st % NS * T::STAGE;
    const float* a_hi = xh + gm0 * PLANE_ROWS;
    const float* a_lo = xh + T::XT + gm0 * PLANE_ROWS;
    const float* b_hi = xh + 2 * T::XT;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t ah = swz_desc(a_hi + 8 * s);
      const uint64_t bh = swz_desc(b_hi + 8 * s);
      wgmma_n128(frag, swz_desc(a_lo + 8 * s), bh, !(fresh && s == 0));
      if constexpr (LUT)
        wgmma_n128(frag, ah, swz_desc(b_hi + T::BT + 8 * s), 1);
      wgmma_n128(frag, ah, bh, 1);
    }
    wgmma_commit();
    // Step st - 1's wgmma are done: its stage is free.
    wgmma_wait<1>();
    if (st > st0 && st - 1 + NS < st1) bar_arrive(1 + NS + (st - 1) % NS);
    if ((st - st0) % TILE_CHAIN == TILE_CHAIN - 1 || st == st1 - 1) {
      wgmma_wait<0>();
      pin(frag);
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) acc[i] = __fadd_rn(acc[i], frag[i]);
    }
  }
  bar_sync(BAR_ROWS);

  // Lane (lane_g, tig) of warp w % 4 holds, of its warpgroup's tile, rows
  // 16 (w % 4) + lane_g (elements 4j, 4j + 1) and + 8 (4j + 2, 4j + 3) at
  // columns 8j + 2 tig + e of n8 tile j; taken 4 n8 tiles at a time.
  const bool ovec = g.N % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(g.out) & 7) == 0 &&
                    (reinterpret_cast<uintptr_t>(sp.part) & 7) == 0;
  const auto rows = [&](auto&& f) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gm0 + 16 * (warp % 4) + lane_g + 8 * h;
      if (m0 + r >= g.M) continue;
#pragma unroll
      for (int q = 0; q < TILE_N / 32; ++q) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[2 * j + e] = acc[4 * (4 * q + j) + 2 * h + e];
        f(r, n0 + 32 * q + 2 * tig, v);
      }
    }
  };
  const auto finish = [&](int r, int nl, float (&v)[8], float rr) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nl + 8 * j + e;
        if (n < g.N)
          v[2 * j + e] = value_out<LUT>(g, v[2 * j + e], rr, g.scale[n],
                                        g.bias ? g.bias[n] : 0.0f);
      }
    put8(g.out + (size_t)(m0 + r) * g.N, nl, g.N, ovec, v);
  };
  if (sp.splits == 1) {
    rows([&](int r, int nl, float (&v)[8]) {
      finish(r, nl, v, LUT ? 0.0f : rsum[r]);
    });
    return;
  }
  // Split K: this block's partials, then the last block of the tile to
  // take a ticket adds the splits' in split order and finishes.
  rows([&](int r, int nl, float (&v)[8]) {
    put8(sp.part + ((size_t)blockIdx.z * g.M + m0 + r) * g.N, nl, g.N, ovec,
         v);
  });
  float* prs = sp.part + (size_t)sp.splits * g.M * g.N;
  if (!LUT && ct < TILE_M && m0 + ct < g.M)
    prs[((size_t)blockIdx.z * gridDim.x + blockIdx.x) * g.M + m0 + ct] =
        rsum[ct];
  __threadfence();  // the partials are visible before the ticket is taken
  bar_sync(BAR_CONSUMERS, TILE_THREADS - PRODUCERS);
  int* ticket = sp.tickets + blockIdx.y * gridDim.x + blockIdx.x;
  if (ct == 0) last = atomicAdd(ticket, 1) == sp.splits - 1;
  bar_sync(BAR_CONSUMERS, TILE_THREADS - PRODUCERS);
  if (!last) return;
  __threadfence();
  rows([&](int r, int nl, float (&)[8]) {
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float rr = 0.0f;
    for (int z = 0; z < sp.splits; ++z) {
      add8(sp.part + ((size_t)z * g.M + m0 + r) * g.N, nl, g.N, ovec, v);
      if constexpr (!LUT)
        rr += __ldcg(prs + ((size_t)z * gridDim.x + blockIdx.x) * g.M + m0 +
                     r);
    }
    finish(r, nl, v, rr);
  });
  if (ct == 0) *ticket = 0;  // ready for the next launch
}

template <int NB, bool LUT>
int launch_tile(const Args& g, const Split& sp, const Table& t,
                cudaStream_t stream) {
  using T = Tile<NB, LUT>;
  const auto kernel = f32_tile_kernel<NB, LUT>;
  // Above 48 KB: the limit is raised at every launch, for the device the
  // launch runs on (it is kept a device and a function).
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.N + TILE_N - 1) / TILE_N, (g.M + TILE_M - 1) / TILE_M,
            sp.splits);
  kernel<<<grid, TILE_THREADS, T::SMEM, stream>>>(g, sp, t);
  return (int)cudaGetLastError();
}

// The streaming route over (strips, splits) blocks, the splits of a strip
// one cluster along K (splits a power of two, at most MAX_CLUSTER; then
// the blocks are at most one an SM, ops/dequant_matmul.py f32_stream_plan,
// and have twice the warps), as the programmatic dependent of the kernel
// before it, so that its start and its word loads overlap that kernel's
// end. At M <= 4 the instantiation that packs x's hi and lo into the n8.
template <int NB, bool LUT, int TOK>
int launch_tokens(const Args& g, int splits, const Table& t,
                  cudaStream_t stream) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = splits;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((g.N + COLS - 1) / COLS, splits);
  cfg.blockDim = dim3(32 * NWARPS * (splits > 1 ? 2 : 1));
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, stream_tf32_kernel<NB, LUT, TOK>, g,
                                 t);
}

template <int NB, bool LUT>
int launch_stream(const Args& g, int splits, const Table& t,
                  cudaStream_t stream) {
  if (splits < 1 || splits > MAX_CLUSTER || (splits & (splits - 1)))
    return (int)cudaErrorInvalidValue;
  const int e = g.M <= 4 ? launch_tokens<NB, LUT, 4>(g, splits, t, stream)
                         : launch_tokens<NB, LUT, 8>(g, splits, t, stream);
  return e != cudaSuccess ? e : (int)cudaGetLastError();
}

template <int NB, bool LUT>
int launch(const Args& g, const Split& sp, const Table& t,
           cudaStream_t stream) {
  if (g.M < 1 || g.kw % PLANE_ROWS != 0) return (int)cudaErrorInvalidValue;
  if (g.M <= 8) return launch_stream<NB, LUT>(g, sp.splits, t, stream);
  if (sp.splits < 1 || (sp.splits > 1 && (!sp.part || !sp.tickets)))
    return (int)cudaErrorInvalidValue;
  return launch_tile<NB, LUT>(g, sp, t, stream);
}

Args f32_args(const void* x, const void* words, const void* scale,
              const void* bias, void* out, int M, int N, int K, int kw,
              float a, float b) {
  return Args{static_cast<const float*>(x), static_cast<const int*>(words),
              static_cast<const float*>(scale),
              static_cast<const float*>(bias), static_cast<float*>(out),
              M, N, K, kw, a, b};
}

}  // namespace

// K8f. x (M, K) f32; words (kw, N) int32 'plane', kw % 32 == 0; scale and
// bias (N,) f32 (bias may be null); lut (ksize,) f32 with ksize <=
// 2^nbits, or null for the affine grid f32(idx)*step + zero; out (M, N)
// f32; splits from f32_stream_plan at M <= 8 (a cluster along K: part and
// tickets unused) or f32_tile_plan above (part (splits, M, N) f32, tickets
// one zeroed int32 a 128 x 128 tile; both null at one split).
extern "C" int plane_lut_matmul_f32(const void* x, const void* words,
                                    const void* scale, const void* bias,
                                    const void* lut, void* out, void* part,
                                    void* tickets, int M, int N, int K,
                                    int kw, int splits, int nbits,
                                    int ksize, float step, float zero,
                                    void* stream) {
  const Args g = f32_args(x, words, scale, bias, out, M, N, K, kw, 1.0f,
                          0.0f);
  const Split sp{static_cast<float*>(part), static_cast<int*>(tickets),
                 splits};
  const Table t{static_cast<const float*>(lut), ksize, step, zero};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return launch<1, true>(g, sp, t, s);
    case 2: return launch<2, true>(g, sp, t, s);
    case 3: return launch<3, true>(g, sp, t, s);
    case 4: return launch<4, true>(g, sp, t, s);
    case 8: return launch<8, true>(g, sp, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K9f. Arguments as K8f without the table; a = step * 2^nbits and b the
// rowsum coefficient of the fold over C - 1.5 (zero + step/2); on the
// tiled route part holds (splits, strips, M) f32 row sums after the
// (splits, M, N) partials (strips of 128 columns).
extern "C" int plane_affine_matmul_f32(const void* x, const void* words,
                                       const void* scale, const void* bias,
                                       void* out, void* part, void* tickets,
                                       int M, int N, int K, int kw,
                                       int splits, int nbits, float a,
                                       float b, void* stream) {
  const Args g = f32_args(x, words, scale, bias, out, M, N, K, kw, a, b);
  const Split sp{static_cast<float*>(part), static_cast<int*>(tickets),
                 splits};
  const Table t{nullptr, 0, 0.0f, 0.0f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return launch<1, false>(g, sp, t, s);
    case 2: return launch<2, false>(g, sp, t, s);
    case 3: return launch<3, false>(g, sp, t, s);
    case 4: return launch<4, false>(g, sp, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
