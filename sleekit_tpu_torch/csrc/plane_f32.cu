// Kernels K8f and K9f of the port: dequantize + matmul over the 'plane'
// layout at f32 activations, held to f32 accuracy: f32 operands and
// accumulation on the CUDA cores at M <= 8, the split-TF32 product on the
// tensor cores above.
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
// - Streaming route (M <= 8): a lane owns 4 consecutive columns, so a
//   warp's word loads are 16 bytes a lane of one word row (512
//   consecutive bytes). K is walked in units of UR word rows of one tile
//   (32 K rows, 40 at 3 bits): the lane loads the next unit's words
//   while this unit's run, the warp stages the unit's x (tokens
//   innermost, MT of them) in its own shared memory, and each field is
//   one FMA into each of MT x 4 accumulators with x broadcast from shared
//   memory. K is split over a block's 8 warps and over blocks
//   (ops/dequant_matmul.py f32_stream_plan) so that OPT-1.3B's N = 2048
//   fills the SMs; the warps' sums meet in shared memory in warp order,
//   the blocks' through partials that the last block of a column strip
//   to take a ticket adds in split order (the tickets are 0 between
//   launches: that block resets its own), so every run of a call gives
//   the same bits, eager or replayed.
// - Tiled route (M > 8), f32_tile_kernel: wgmma (m64 n128 k8)
//   TF32 on split operands, both from shared memory, K-major, with the
//   128-byte swizzle (a step's 32 K rows are one 128-byte row). A weight
//   value v is hi = cvt.rna.tf32(v) plus lo = cvt.rna.tf32(v - hi) (v - hi
//   exact), split once a block into a (hi, lo) table in shared memory, so
//   a weight decodes into both halves with one lookup; K9f's C - 1.5 is
//   exact in TF32 (lo = 0). x is staged as it comes and the tensor cores
//   read its top 19 bits (hi = v truncated), beside lo = cvt.rna.tf32(v -
//   hi) from that same hi: hi + lo is within 2^-21 |v|. A product is
//   a_lo*b_hi + a_hi*b_lo, then a_hi*b_hi, into one accumulator (K9f
//   without a_hi*b_lo); a_lo*b_lo (about 2^-21 of it) is dropped.
//   Accumulation: the tensor cores align a sum's terms to the largest,
//   truncate each 25 bits below it and truncate the sum to f32
//   (tests/test_torch_cuda.py test_tf32_mma_truncates), a bias towards
//   zero of up to one f32 step an instruction: over fc2's K = 8192 in one
//   chain, 8e-5 of the largest output in an emulation with x >= 0
//   (tests/test_torch_plane_f32.py test_tile_chain_holds_1e5). So the
//   chains are short: the fragment starts afresh every TILE_CHAIN = 4
//   steps (48 wgmma of 8 K, 32 for K9f) and is then added into f32
//   accumulators with __fadd_rn (1.4e-6 in the same emulation).
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
//   from the staged x, in a fixed order: at M <= 8 by the warps, above by
//   the producers (4 values pairwise, over a row's 8 lanes, Kahan over the
//   steps). The epilogue applies a, b, scale and bias and writes f32.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PLANE_ROWS = 32;  // word rows per plane tile
constexpr int SCOLS = 128;      // streaming block's columns: 4 a lane
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

// The K split over blocks: splits slices, and above one the partial sums
// (splits, M, N), then K9f's partial row sums (splits, strips of 128
// columns, M), and one ticket per column strip (streaming route) or per
// tile (tiled route), 0 between launches.
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

template <int NB, bool LUT>
struct Rule {
  static constexpr int VPW = NB == 3 ? 10 : 32 / NB;  // fields a word
  static constexpr int BK = PLANE_ROWS * VPW;         // K rows a tile
  static constexpr int UR = NB == 3 ? 4 : 32 / VPW;   // word rows a unit
  static constexpr int UK = UR * VPW;                 // K rows a unit
  static constexpr uint32_t MASK = (1u << NB) - 1u;
  static constexpr int TAB = LUT ? 1 << NB : 1;
  static_assert(PLANE_ROWS % UR == 0, "a unit lies in one tile");

  // K8f: the table in shared memory, f32 as given (the 8-bit grid as
  // the plain version computes it: a product, then a sum, each rounded).
  // Every thread of the block calls it.
  static __device__ __forceinline__ void setup(float* tab, const Table& t) {
    if constexpr (LUT) {
      for (int i = threadIdx.x; i < (1 << NB); i += blockDim.x)
        tab[i] = t.lut ? (i < t.ksize ? t.lut[i] : 0.0f)
                       : __fadd_rn(__fmul_rn((float)i, t.step), t.zero);
    }
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
        split_tf32(t.lut ? (i < t.ksize ? t.lut[i] : 0.0f)
                         : __fadd_rn(__fmul_rn((float)i, t.step), t.zero),
                   hi, lo);
        tab[2 * i] = __uint_as_float(hi);
        tab[2 * i + 1] = __uint_as_float(lo);
      } else {
        tab[i] = value((uint32_t)i, 0, nullptr);
      }
    }
    __syncthreads();
  }

  // The weight of field j of word w: v[idx], or C - 1.5 = idx/2^NB - 0.5.
  static __device__ __forceinline__ float value(uint32_t w, int j,
                                                const float* tab) {
    const uint32_t idx = (w >> (NB * j)) & MASK;
    if constexpr (LUT) {
      return tab[idx];
    } else {
      return __fsub_rn(__fmul_rn((float)idx, 1.0f / (1 << NB)), 0.5f);
    }
  }
};

// Output column n from its sum s (and K9f's row sum r).
template <bool LUT>
__device__ __forceinline__ float value_out(const Args& g, int n, float s,
                                           float r) {
  float y = LUT ? __fmul_rn(s, g.scale[n])
                : __fmul_rn(__fadd_rn(__fmul_rn(g.a, s), __fmul_rn(g.b, r)),
                            g.scale[n]);
  return g.bias ? __fadd_rn(y, g.bias[n]) : y;
}

template <bool LUT>
__device__ __forceinline__ void store(const Args& g, int m, int n, float s,
                                      float r) {
  g.out[(size_t)m * g.N + n] = value_out<LUT>(g, n, s, r);
}

// Columns n .. n + 3 of word row r: one 16-byte load where vec, else four
// 4-byte ones; zeros past N.
__device__ __forceinline__ void load4(const int* words, int r, int N, int n,
                                      bool vec, uint32_t (&w)[4]) {
  const int* p = words + (size_t)r * N + n;
  if (vec) {
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = n + c < N ? (uint32_t)__ldg(p + c) : 0u;
  }
}

// MT consecutive floats of shared memory (MT = 1, 2, 4 or 8).
template <int MT>
__device__ __forceinline__ void load_tokens(const float* p, float (&v)[MT]) {
  if constexpr (MT >= 4) {
#pragma unroll
    for (int q = 0; q < MT / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else if constexpr (MT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// The streaming route at M <= MT <= 8: block (x, y) takes the SCOLS-column
// strip x over K slice y of sp.splits (units in equal shares), its warps
// over 8 sub-slices.
template <int NB, bool LUT, int MT>
__global__ void __launch_bounds__(THREADS)
    f32_stream_kernel(Args g, Split sp, Table t) {
  using R = Rule<NB, LUT>;
  __shared__ float tab[R::TAB];
  __shared__ __align__(16) float xs[NWARPS][R::UK][MT];
  __shared__ __align__(16) float red[NWARPS][MT][SCOLS];
  __shared__ float rsw[NWARPS][MT];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * SCOLS, n = n0 + 4 * lane;
  const bool vec = g.N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(g.w) & 15) == 0;
  const int units = g.kw / R::UR;
  const int b0 = units * blockIdx.y / sp.splits;
  const int b1 = units * (blockIdx.y + 1) / sp.splits;
  const int u0 = b0 + (b1 - b0) * warp / NWARPS;
  const int u1 = b0 + (b1 - b0) * (warp + 1) / NWARPS;
  R::setup(tab, t);

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;
  float rs = 0.0f;  // K9f: token lane % MT's sum over the x it stages

  uint32_t w[R::UR][4], wn[R::UR][4];
  const auto load_w = [&](int u, uint32_t (&wu)[R::UR][4]) {
#pragma unroll
    for (int i = 0; i < R::UR; ++i)
      load4(g.w, u * R::UR + i, g.N, n, vec, wu[i]);
  };
  if (u0 < u1) load_w(u0, w);
  float(&xw)[R::UK][MT] = xs[warp];
  for (int u = u0; u < u1; ++u) {
    if (u + 1 < u1) load_w(u + 1, wn);
    // Unit u: word rows r0 .. r0 + UR - 1, in one tile; field j of word
    // row r0 + i holds K row kt + j*32 + i, staged as xw[j*UR + i][token].
    const int r0 = u * R::UR;
    const int kt = r0 / PLANE_ROWS * R::BK + r0 % PLANE_ROWS;
    for (int e = lane; e < R::UK * MT; e += 32) {
      const int m = e % MT, l = e / MT;
      const int k = kt + l / R::UR * PLANE_ROWS + l % R::UR;
      const float v = m < g.M && k < g.K ? __ldg(g.x + (size_t)m * g.K + k)
                                         : 0.0f;
      xw[l][m] = v;
      if constexpr (!LUT) rs += v;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < R::UR; ++i)
#pragma unroll
      for (int j = 0; j < R::VPW; ++j) {
        float xv[MT];
        load_tokens<MT>(xw[j * R::UR + i], xv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = R::value(w[i][c], j, tab);
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xv[m], v, acc[m][c]);
        }
      }
    __syncwarp();  // xw is read before the next unit's staging
#pragma unroll
    for (int i = 0; i < R::UR; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[i][c] = wn[i][c];
  }

  if constexpr (!LUT) {
    // A lane stages token lane % MT only: the lanes of one token meet.
#pragma unroll
    for (int o = MT; o < 32; o <<= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, o);
    if (lane < MT) rsw[warp][lane] = rs;
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][4 * lane]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const auto row_sum = [&](int m) {
    float r = 0.0f;
    if constexpr (!LUT)
#pragma unroll
      for (int v = 0; v < NWARPS; ++v) r += rsw[v][m];
    return r;
  };
  for (int e = tid; e < MT * SCOLS; e += THREADS) {
    const int m = e / SCOLS, c = e % SCOLS, nn = n0 + c;
    if (m >= g.M || nn >= g.N) continue;
    float s = 0.0f;
#pragma unroll
    for (int v = 0; v < NWARPS; ++v) s += red[v][m][c];
    if (sp.splits == 1)
      store<LUT>(g, m, nn, s, row_sum(m));
    else
      sp.part[((size_t)blockIdx.y * g.M + m) * g.N + nn] = s;
  }
  if (sp.splits == 1) return;
  const int strips = gridDim.x;
  float* prs = sp.part + (size_t)sp.splits * g.M * g.N;
  if (!LUT && tid < g.M)
    prs[((size_t)blockIdx.y * strips + blockIdx.x) * g.M + tid] = row_sum(tid);
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(sp.tickets + blockIdx.x, 1) == sp.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < MT * SCOLS; e += THREADS) {
    const int m = e / SCOLS, c = e % SCOLS, nn = n0 + c;
    if (m >= g.M || nn >= g.N) continue;
    float s = 0.0f, r = 0.0f;
    for (int y = 0; y < sp.splits; ++y) {
      s += __ldcg(sp.part + ((size_t)y * g.M + m) * g.N + nn);
      if constexpr (!LUT)
        r += __ldcg(prs + ((size_t)y * strips + blockIdx.x) * g.M + m);
    }
    store<LUT>(g, m, nn, s, r);
  }
  if (tid == 0) sp.tickets[blockIdx.x] = 0;  // ready for the next launch
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

// s += v with Kahan's compensation c (K9f's row sums).
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
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
      for (int e = 0; e < 2; ++e)
        if (nl + 8 * j + e < g.N)
          v[2 * j + e] = value_out<LUT>(g, nl + 8 * j + e, v[2 * j + e], rr);
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

template <int NB, bool LUT>
int launch(const Args& g, const Split& sp, const Table& t,
           cudaStream_t stream) {
  if (g.M < 1 || g.kw % PLANE_ROWS != 0) return (int)cudaErrorInvalidValue;
  if (sp.splits < 1 || (sp.splits > 1 && (!sp.part || !sp.tickets)))
    return (int)cudaErrorInvalidValue;
  if (g.M > 8) return launch_tile<NB, LUT>(g, sp, t, stream);
  dim3 grid((g.N + SCOLS - 1) / SCOLS, sp.splits);
  if (g.M == 1)
    f32_stream_kernel<NB, LUT, 1><<<grid, THREADS, 0, stream>>>(g, sp, t);
  else if (g.M == 2)
    f32_stream_kernel<NB, LUT, 2><<<grid, THREADS, 0, stream>>>(g, sp, t);
  else if (g.M <= 4)
    f32_stream_kernel<NB, LUT, 4><<<grid, THREADS, 0, stream>>>(g, sp, t);
  else
    f32_stream_kernel<NB, LUT, 8><<<grid, THREADS, 0, stream>>>(g, sp, t);
  return (int)cudaGetLastError();
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
// f32; part, tickets and splits from f32_stream_plan at M <= 8 (part
// (splits, M, N) f32, tickets one zeroed int32 a 128-column strip) or
// f32_tile_plan above (part the same, tickets one a 128 x 128 tile);
// both null at one split.
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
// rowsum coefficient of the fold over C - 1.5 (zero + step/2); part holds
// (splits, strips, M) f32 row sums after the (splits, M, N) partials
// (strips: of 128 columns, at either route).
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
