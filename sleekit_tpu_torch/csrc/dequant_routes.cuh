// The two routes shared by the port's dequant-matmul kernels: K1 ('pair'),
// K6 ('pair3x') and K7 ('pair3') in dequant_matmul.cu, K8 ('plane' over a
// table) and K9 ('plane' over an affine grid) in plane_matmul.cu; K2 (the
// int8 head, dequant_matmul.cu) shares the prologue pass. Every call first
// runs prologue_kernel, which writes pre(x) once, as bf16 into the scratch
// xp (M, K rounded up to 64, 0 past K), with its row sums in rs (norm
// statistics and activations are never recomputed per block). Then:
// - M > 8, pair_mma_kernel: xp times the decoded words on the tensor cores
//   (mma.sync m16n8k16 bf16, f32 accumulation). The B registers are built
//   straight from the words (no dequantized tile exists in shared memory);
//   A and the words arrive by cp.async in a ring of three 64-row stages; A
//   fragments come from shared memory by ldmatrix.
// - M <= 8, pair_stream_kernel: bound by the word stream, so the operands
//   swap: the decoded weight is the m16n8k16 A operand (16 output columns
//   by 16 K rows) and the <= 8 tokens are the n8 B operand, one 8-byte
//   load of xp per lane and k16 step, so no product row is wasted. Each
//   lane loads 16 bytes along N (four columns of one word row) and every
//   word it loads serves all of its steps in the unit; the next unit's
//   words and x are in flight in registers while this unit's products
//   run. The kernel is the prologue pass's programmatic dependent, so its
//   blocks start, and load their first words, while the pass runs. K is
//   split over a block's 8 warps and, where the column strips alone would
//   leave SMs idle, over blocks; the partial sums meet in a fixed order
//   (warps in a block through shared memory, blocks through a scratch of
//   partials and a ticket per strip: the last block to arrive adds them
//   in split order), so a call is bit for bit the same on every run.
// Both end in out = [res +] (a*acc + b*rs)*scale + bias, bf16.
//
// A tile rule P (the layout's word geometry and decoder) supplies, as
// static members:
//   WPAD              int32 padding of a shared word row (MmaTile)
//   setup(aux...)     its decoder's state in shared memory (K8's table),
//                     from the kernel's aux parameters; null for the rest
//   chunk_words(c)    (first, count <= MMA_KW) word rows of 64-row chunk c
//   mma_chunk<WM, WN, MINB>(acc, sa, ws, c, t4, tab)
//                     the products of chunk c on the tensor-core route
//   RW, STEPS         word rows a lane loads, k16 steps, per decode unit
//   stream_units(kw)  the decode route's units of kw word rows
//   step_row(u, s)    first K row (a multiple of 16) of step s of unit u,
//                     or NO_ROW
//   unit_rows(u, t4, r)  the word rows lane t4 loads for unit u (-1: none)
//   stream_unit(acc, w, x, u, K, tab)  the products of unit u
// The rule's own parameters (K8's table) travel as the kernels' aux
// parameters, not in Args (Split's note).
#pragma once

#include "common.cuh"

namespace {

enum Pre { PRE_NONE = 0, PRE_LN = 1, PRE_RMS = 2, PRE_RELU = 3, PRE_GELU = 4,
           PRE_GLU = 5 };

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// Columns a decode block streams (pair_stream_kernel): lane (g, t4) of
// each warp holds columns 4g .. 4g + 3 of the strip.
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

// The K split over blocks at M <= 8 (pair_stream_kernel): splits slices,
// and above one the partial sums (splits, M, N) and one ticket per column
// strip. Kept out of Args: a larger Args made int8_mma_kernel 11% slower
// at M = 64 (PERF.md).
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

// A block of 8 warps, 2 along M and 4 along N, each warp WM m16 tiles by
// WN n8 tiles. A rows are padded by 16 bytes so that ldmatrix's eight rows
// fall on distinct banks, word rows by the tile rule's WPAD int32 (8 where
// a B load reads word rows t4 + c, 4 where it reads 2*t4 + c), so that a
// B load's lanes fall on distinct banks.
template <int WM, int WN, int WPAD>
struct MmaTile {
  static constexpr int BM = 2 * 16 * WM, BN = 4 * 8 * WN;
  static constexpr int A_LD = MMA_KC + 8;  // bf16 per A row
  static constexpr int W_LD = BN + WPAD;   // int32 per word row
  static constexpr int A_BYTES = BM * A_LD * 2;
  static constexpr int STAGE = A_BYTES + MMA_KW * W_LD * 4;
  static constexpr int SMEM = MMA_STAGES * STAGE;
};

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
// of xp and their word rows (P::chunk_words) stream through a ring of
// MMA_STAGES stages, and P::mma_chunk runs each chunk's products. MINB
// blocks per SM (2 caps the registers at 128 a thread). aux is the rule's
// own parameter (K8's table), none for the others.
template <class P, int WM, int WN, int MINB, class... Aux>
__global__ void __launch_bounds__(THREADS, MINB)
    pair_mma_kernel(Args g, Aux... aux) {
  using T = MmaTile<WM, WN, P::WPAD>;
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
  const uint32_t* tab = P::setup(aux...);

  auto load = [&](int c, int st) {
    bf16* sa = reinterpret_cast<bf16*>(smem + st * T::STAGE);
    int* sw = reinterpret_cast<int*>(smem + st * T::STAGE + T::A_BYTES);
    for (int i = tid; i < T::BM * (MMA_KC / 8); i += THREADS) {
      const int r = i / (MMA_KC / 8), q = i % (MMA_KC / 8);
      const int m = min(m0 + r, g.M - 1);  // rows past M: never stored
      cp16(sa + r * T::A_LD + 8 * q,
           g.xp + (size_t)m * kp + c * MMA_KC + 8 * q, true);
    }
    const int2 cw = P::chunk_words(c);
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
    P::template mma_chunk<WM, WN, MINB>(acc, sa, ws, c, t4, tab);
  }

  mma_epilogue<WM, WN>(g, acc, m0 + wm * 16 * WM, n0 + wn * 8 * WN, lane);
}

template <class P, int WM, int WN, int MINB, class... Aux>
int launch_mma(const Args& g, cudaStream_t stream, const Aux&... aux) {
  using T = MmaTile<WM, WN, P::WPAD>;
  static int raised = 0;
  cudaError_t err = allow_smem(pair_mma_kernel<P, WM, WN, MINB, Aux...>,
                               T::SMEM, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.N + T::BN - 1) / T::BN, (g.M + T::BM - 1) / T::BM);
  pair_mma_kernel<P, WM, WN, MINB, Aux...>
      <<<grid, THREADS, T::SMEM, stream>>>(g, aux...);
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

constexpr int NO_ROW = 1 << 30;

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

// The decode route at M <= 8 after the prologue pass: block (x, y) streams
// the PAIR_COLS-column strip x over K slice y of sp.splits (units in equal
// shares), its 8 warps over 8 sub-slices. Each lane keeps the next
// unit's words and x in flight in registers while this unit's products
// run. The warps' sums meet in shared memory in warp order; with one
// slice the block applies the epilogue, else it writes its sums to
// sp.part, and the last block of the strip to take a ticket adds the
// slices in slice order and applies it.
template <class P, class... Aux>
__global__ void __launch_bounds__(THREADS, 2)
    pair_stream_kernel(Args g, Split sp, Aux... aux) {
  __shared__ float4 red[NWARPS][8][PAIR_COLS / 4];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * PAIR_COLS, n = n0 + 4 * gq;
  const int* words = static_cast<const int*>(g.w);
  const bool vec = g.N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  const int units = P::stream_units(g.kw);
  const int b0 = units * blockIdx.y / sp.splits;
  const int b1 = units * (blockIdx.y + 1) / sp.splits;
  const int u0 = b0 + (b1 - b0) * warp / NWARPS;
  const int u1 = b0 + (b1 - b0) * (warp + 1) / NWARPS;
  const bool tok = gq < g.M;  // the lane's token (the n8 column g)
  const bf16* xrow = g.xp + (size_t)(tok ? gq : 0) * xp_cols(g.K) + 4 * t4;
  // The rule's decoder state (K8's table) does not depend on the prologue
  // pass either.
  const uint32_t* tab = P::setup(aux...);

  const auto load_w = [&](int u, uint32_t (&wu)[P::RW][4]) {
    int r[P::RW];
    P::unit_rows(u, t4, r);
#pragma unroll
    for (int i = 0; i < P::RW; ++i)
      load_cols(words, r[i], g.kw, g.N, n, vec, wu[i]);
  };
  const auto load_x = [&](int u, uint32_t (&xu)[P::STEPS][2]) {
#pragma unroll
    for (int s = 0; s < P::STEPS; ++s) {
      const int k = P::step_row(u, s);
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
  uint32_t w[D][P::RW][4], x[D][P::STEPS][2];
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
      if (u + d < u1) P::stream_unit(acc, w[d], x[d], u + d, g.K, tab);
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
template <class P, class... Aux>
int launch_pair_m(const Args& g, const Split& sp, cudaStream_t stream,
                  const Aux&... aux) {
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
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, pair_stream_kernel<P, Aux...>, g, sp, aux...);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  using Wide = MmaTile<4, 4, P::WPAD>;
  const int wide = ((g.M + Wide::BM - 1) / Wide::BM) *
                   ((g.N + Wide::BN - 1) / Wide::BN);
  if (wide >= 264) return launch_mma<P, 4, 4, 2>(g, stream, aux...);
  if (wide >= 64) return launch_mma<P, 4, 4, 1>(g, stream, aux...);
  return launch_mma<P, 1, 2, 1>(g, stream, aux...);
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

}  // namespace
