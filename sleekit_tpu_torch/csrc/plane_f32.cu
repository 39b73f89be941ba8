// Kernels K8f and K9f of the port: dequantize + matmul over the 'plane'
// layout at f32 activations, f32 operands and f32 accumulation on the
// CUDA cores.
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
// above, the f32 operations at 67 TFLOP/s outside the tensor cores (TF32
// keeps about 3 decimal digits and misses the 1e-5 criteria; a 3xTF32
// split is later work).
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
// - Tiled route (M > 8): a block of 128 threads computes a 64 x 64 tile
//   of the output, 8 x 4 a thread (three 16-byte shared loads feed 32
//   FMAs). A thread keeps 16 words of the tile's 32 word rows in
//   registers; one step is one field of them, 32 consecutive K rows: the
//   (32 x 64) weight slice is decoded once into shared memory as f32 and
//   the (64 x 32) x slice staged beside it (K-major), then 32 rank-1
//   updates; the next step's x (and the next tile's words) load into
//   registers while they run. (Two shared buffers with one barrier a
//   step were no faster on an H100 at OPT-1.3B's shapes: PERF.md.)
// - K9f's row sums are summed in f32 inside the launch from the staged x,
//   in a fixed order. The epilogue applies a, b, scale and bias and
//   writes f32.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PLANE_ROWS = 32;  // word rows per plane tile
constexpr int SCOLS = 128;      // streaming block's columns: 4 a lane
constexpr int TM = 64, TN = 64; // tiled route's block tile
constexpr int TILE_THREADS = 128;
constexpr int XLD = TM + 4;     // floats per K row of the staged x tile

struct Args {
  const float* x;
  const int* w;
  const float* scale;
  const float* bias;
  float* out;
  int M, N, K, kw;
  float a, b;  // K9f: out = (a*acc + b*rowsum)*scale + bias
};

// The K split of the streaming route: splits slices, and above one the
// partial sums (splits, M, N), then K9f's partial row sums (splits,
// strips, M), and one ticket per column strip, 0 between launches.
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

// Output (m, n) from its sum s (and K9f's row sum r).
template <bool LUT>
__device__ __forceinline__ void store(const Args& g, int m, int n, float s,
                                      float r) {
  float y = LUT ? __fmul_rn(s, g.scale[n])
                : __fmul_rn(__fadd_rn(__fmul_rn(g.a, s), __fmul_rn(g.b, r)),
                            g.scale[n]);
  if (g.bias) y = __fadd_rn(y, g.bias[n]);
  g.out[(size_t)m * g.N + n] = y;
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

// The tiled route at M > 8: block (x, y) of TILE_THREADS threads computes
// out[64y .., 64x ..], 8 rows by 4 columns a thread. Step s is K rows 32s
// .. 32s + 31: field s % VPW of tile s / VPW's 32 word rows. A thread
// keeps 16 words of the tile (word rows wr + 2i of column wc) and 16 x
// values of the step (K row 32s + lane of rows warp + 4i) in registers,
// and loads the next step's (and, at a tile's last field, the next
// tile's words) while this step's products run.
template <int NB, bool LUT>
__global__ void __launch_bounds__(TILE_THREADS)
    f32_tile_kernel(Args g, Table t) {
  using R = Rule<NB, LUT>;
  constexpr int WI = PLANE_ROWS * TN / TILE_THREADS;  // words a thread
  constexpr int XI = PLANE_ROWS * TM / TILE_THREADS;  // x values a thread
  constexpr int WSTEP = TILE_THREADS / TN, XSTEP = TILE_THREADS / 32;
  __shared__ float tab[R::TAB];
  __shared__ __align__(16) float xs[PLANE_ROWS][XLD];  // xs[k][m]
  __shared__ __align__(16) float ws[PLANE_ROWS][TN];   // ws[k][n]
  __shared__ float rsum[TM];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;  // columns 4tx.., rows 8ty..
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int wc = tid % TN, wr = tid / TN;
  const bool col = n0 + wc < g.N;
  R::setup(tab, t);

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  float rsp[XI];  // K9f: the x this thread stages, by row warp + 4i
#pragma unroll
  for (int i = 0; i < XI; ++i) rsp[i] = 0.0f;

  uint32_t w[WI];
  float xr[XI];
  const auto load_words = [&](int tile) {
#pragma unroll
    for (int i = 0; i < WI; ++i)
      w[i] = col ? (uint32_t)__ldg(g.w + (size_t)(tile * PLANE_ROWS + wr +
                                                  WSTEP * i) * g.N + n0 + wc)
                 : 0u;
  };
  const auto load_x = [&](int step) {
    const int k = step * PLANE_ROWS + lane;
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int gm = m0 + warp + XSTEP * i;
      xr[i] = gm < g.M && k < g.K ? __ldg(g.x + (size_t)gm * g.K + k) : 0.0f;
    }
  };
  // The steps that hold K rows below K.
  const int steps = min(g.kw / PLANE_ROWS * R::VPW,
                        (g.K + PLANE_ROWS - 1) / PLANE_ROWS);
  if (steps > 0) {
    load_words(0);
    load_x(0);
  }
  for (int step = 0; step < steps; ++step) {
    const int j = step % R::VPW;
    __syncthreads();  // the previous step's slices are consumed
#pragma unroll
    for (int i = 0; i < WI; ++i)
      ws[wr + WSTEP * i][wc] = R::value(w[i], j, tab);
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      xs[lane][warp + XSTEP * i] = xr[i];
      if constexpr (!LUT) rsp[i] += xr[i];
    }
    __syncthreads();
    if (step + 1 < steps) {
      if (j == R::VPW - 1) load_words((step + 1) / R::VPW);
      load_x(step + 1);
    }
#pragma unroll 8
    for (int kk = 0; kk < PLANE_ROWS; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[kk][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[kk][8 * ty + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
  if constexpr (!LUT) {
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const float s = warp_sum(rsp[i]);
      if (lane == 0) rsum[warp + XSTEP * i] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + 8 * ty + r;
    if (m >= g.M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + 4 * tx + c;
      if (n < g.N)
        store<LUT>(g, m, n, acc[r][c], LUT ? 0.0f : rsum[8 * ty + r]);
    }
  }
}

template <int NB, bool LUT>
int launch(const Args& g, const Split& sp, const Table& t,
           cudaStream_t stream) {
  if (g.M < 1 || g.kw % PLANE_ROWS != 0) return (int)cudaErrorInvalidValue;
  if (g.M > 8) {
    dim3 grid((g.N + TN - 1) / TN, (g.M + TM - 1) / TM);
    f32_tile_kernel<NB, LUT><<<grid, TILE_THREADS, 0, stream>>>(g, t);
    return (int)cudaGetLastError();
  }
  if (sp.splits < 1 || (sp.splits > 1 && (!sp.part || !sp.tickets)))
    return (int)cudaErrorInvalidValue;
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
// f32; at M <= 8 part, tickets and splits from f32_stream_plan (part
// (splits, M, N) f32 and tickets one zeroed int32 a strip, both null at
// one split).
extern "C" int plane_lut_matmul_f32(const void* x, const void* words,
                                    const void* scale, const void* bias,
                                    const void* lut, void* out, void* part,
                                    void* tickets, int M, int N, int K,
                                    int kw, int splits, int nbits, int ksize,
                                    float step, float zero, void* stream) {
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
// (splits, strips, M) f32 row sums after the (splits, M, N) partials.
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
