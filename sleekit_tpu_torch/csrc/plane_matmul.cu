// Kernels K8 and K9 of the port: dequantize + matmul over the 'plane'
// layout, one body with one value rule each.
//
// Replaces:
//   K8  sleekit_tpu/ops/dequant_matmul.py  _pallas_impl / _kernel
//       (table codebooks: NF4, any k <= 2^nbits in any order; and 8-bit
//       affine codebooks)
//   K9  sleekit_tpu/ops/dequant_matmul.py  _pallas_impl / _mantissa_kernel
//       (affine codebooks, nbits <= 7)
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
// them).
//
// What bounds it on an H100: at decode (M = 8) the packed weight stream
// over device memory, as K1; at prefill M the products on the CUDA cores.
//
// What the design does about it: K1's blocking (16 K slices x 16 columns
// of 256 threads, 8- or 16-row M tiles, x chunks of about 512 K rows in
// shared memory, words double-buffered in registers, the K slices summed
// through shared memory). K8 reads each value from a 2^nbits-entry table
// that every block fills in shared memory, already rounded to bf16 as the
// TPU kernel rounds it; K9 ORs each field into an f32 mantissa (C, exact)
// and accumulates C - 1.5, as K1 does, so the fold does not cancel. This
// is the simple first version: CUDA-core FMAs, no tensor cores, no TMA.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KSPLIT = 16;   // K slices (threads along K) per block
constexpr int BN = 16;       // threads along N per block
constexpr int NWARPS = THREADS / 32;
constexpr int LOADS = 8;     // independent loads in flight per lane
constexpr int GROUP = 32;    // word rows per plane tile

struct Args {
  const bf16* x;
  const int* w;
  const float* scale;
  const float* bias;
  const float* lut;  // K8: the table, or null for the affine grid
  bf16* out;
  int M, N, K, kw, ksize;
  float a, b, step, zero;
};

// Plane geometry: VPW fields a word, BK K rows per tile, TPC tiles per
// shared-memory chunk.
template <int NB>
struct Plane {
  static constexpr int VPW = NB == 3 ? 10 : 32 / NB;
  static constexpr int BK = GROUP * VPW;
  static constexpr int TPC = BK >= 512 ? 1 : 512 / BK;
  static constexpr int CW = TPC * GROUP;  // word rows per chunk
  static constexpr int CK = TPC * BK;     // K rows per chunk
};

// xs[c * BM + m] = x[m0 + m, k0 + c] for c < ck (0 past K or M); with
// ROWSUM, rs[m] += the chunk's row sums. One warp per row, lanes along K.
template <int BM, bool ROWSUM>
__device__ void fill_x(const Args& g, int m0, int k0, int ck, float* xs,
                       float* rs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < BM; m += NWARPS) {
    const bool row_ok = m0 + m < g.M;
    const bf16* row = g.x + (size_t)(m0 + m) * g.K;
    float part = 0.0f;
    for (int c0 = 0; c0 < ck; c0 += 32 * LOADS) {
      float v[LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int c = c0 + lane + 32 * i, k = k0 + c;
        v[i] = row_ok && c < ck && k < g.K ? to_f(row[k]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int c = c0 + lane + 32 * i;
        if (c < ck) xs[c * BM + m] = v[i];
        part += v[i];
      }
    }
    if (ROWSUM) {
      part = warp_sum(part);
      if (lane == 0) rs[m] += part;
    }
  }
}

// Word rows kw0 + ks + i*KSPLIT (i < WPT) of NV columns from n; 0 past
// the matrix.
template <int WPT, int NV>
__device__ __forceinline__ void load_words(uint32_t (&w)[WPT][NV],
                                           const int* words, int kw0, int kw,
                                           int N, int n, int ks) {
#pragma unroll
  for (int i = 0; i < WPT; ++i) {
    const int row = kw0 + ks + i * KSPLIT;
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

// NV consecutive columns per thread: 1 at decode, 4 at prefill M (needs
// N % 4 == 0). LUT selects K8's value rule, else K9's.
template <int NB, bool LUT, int BM, int NV>
__global__ void __launch_bounds__(THREADS, BM == 8 ? 2 : 1)
    plane_kernel(Args g) {
  using P = Plane<NB>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  __shared__ float rs[BM];
  __shared__ float table[LUT ? (1 << NB) : 1];
  const int ks = threadIdx.x / BN, cn = threadIdx.x % BN;
  const int n0 = blockIdx.x * BN * NV, m0 = blockIdx.y * BM;
  const int n = n0 + cn * NV;
  if (threadIdx.x < BM) rs[threadIdx.x] = 0.0f;
  if constexpr (LUT) {
    for (int i = threadIdx.x; i < (1 << NB); i += THREADS)
      table[i] = g.lut ? (i < g.ksize ? round_bf16(g.lut[i]) : 0.0f)
                       : round_bf16(__fadd_rn(__fmul_rn((float)i, g.step),
                                              g.zero));
  }
  __syncthreads();

  constexpr uint32_t fmask = ((1u << NB) - 1u);
  float acc[BM][NV];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[m][v] = 0.0f;

  constexpr int WPT = P::CW / KSPLIT;  // word rows per thread per chunk
  uint32_t wn[WPT][NV];
  load_words<WPT, NV>(wn, g.w, 0, g.kw, g.N, n, ks);
  for (int kw0 = 0; kw0 < g.kw; kw0 += P::CW) {
    const int cw = min(P::CW, g.kw - kw0);
    uint32_t wb[WPT][NV];
#pragma unroll
    for (int i = 0; i < WPT; ++i)
#pragma unroll
      for (int v = 0; v < NV; ++v) wb[i][v] = wn[i][v];
    if (kw0 + P::CW < g.kw)
      load_words<WPT, NV>(wn, g.w, kw0 + P::CW, g.kw, g.N, n, ks);
    __syncthreads();  // the previous chunk is consumed
    fill_x<BM, !LUT>(g, m0, kw0 / GROUP * P::BK, cw / GROUP * P::BK, xs, rs);
    __syncthreads();
    if (n >= g.N) continue;
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int r = ks + i * KSPLIT;
      if (r >= cw) break;
      uint32_t w[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) w[v] = wb[i][v];
      const int t = r / GROUP, gr = r - t * GROUP;
      const float* xt = xs + (t * P::BK + gr) * BM;
#pragma unroll
      for (int j = 0; j < P::VPW; ++j) {
        float c[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if constexpr (LUT) {
            c[v] = table[(w[v] >> (NB * j)) & fmask];
          } else {
            // field j into the top of the f32 mantissa: C = 1 + idx/2^NB
            const int s = 23 - NB - NB * j;
            uint32_t u = s >= 0 ? (w[v] << s) : (w[v] >> (-s));
            u = (u & (fmask << (23 - NB))) | 0x3F800000u;
            c[v] = __uint_as_float(u) - 1.5f;
          }
        }
        const float* xl = xt + j * GROUP * BM;
#pragma unroll
        for (int m = 0; m < BM; m += 4) {
          const float4 a = *reinterpret_cast<const float4*>(xl + m);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int v = 0; v < NV; ++v) acc[m + e][v] += av[e] * c[v];
        }
      }
    }
  }

  // Sum the K slices through shared memory (reusing the x chunk buffer);
  // K8 passes a = 1, b = 0 (and its rowsum stays 0).
  constexpr int COLS = BN * NV;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int v = 0; v < NV; ++v)
      xs[(ks * BM + m) * COLS + cn * NV + v] = acc[m][v];
  __syncthreads();
  for (int e = threadIdx.x; e < BM * COLS; e += THREADS) {
    const int m = e / COLS, c = e % COLS;
    const int gm = m0 + m, gn = n0 + c;
    if (gm >= g.M || gn >= g.N) continue;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < KSPLIT; ++k) s += xs[(k * BM + m) * COLS + c];
    float y = (g.a * s + g.b * rs[m]) * g.scale[gn];
    if (g.bias) y += g.bias[gn];
    g.out[(size_t)gm * g.N + gn] = __float2bfloat16_rn(y);
  }
}

template <int NB, bool LUT, int BM, int NV>
int launch(const Args& g, cudaStream_t stream) {
  using P = Plane<NB>;
  constexpr int red = KSPLIT * BM * BN * NV;
  const int bytes = 4 * (P::CK * BM > red ? P::CK * BM : red);
  static bool raised = false;
  cudaError_t err = allow_smem(plane_kernel<NB, LUT, BM, NV>, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((g.N + BN * NV - 1) / (BN * NV), (g.M + BM - 1) / BM);
  plane_kernel<NB, LUT, BM, NV><<<grid, THREADS, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int NB, bool LUT>
int launch_m(const Args& g, cudaStream_t stream) {
  if (g.M <= 8) return launch<NB, LUT, 8, 1>(g, stream);
  if (g.N % 4 == 0) return launch<NB, LUT, 16, 4>(g, stream);
  return launch<NB, LUT, 16, 1>(g, stream);
}

}  // namespace

// K8. x (M, K) bf16; words (kw, N) int32 'plane', kw % 32 == 0; scale and
// bias (N,) f32 (bias may be null); lut (ksize,) f32 with ksize <= 2^nbits,
// or null for the affine grid f32(idx)*step + zero; out (M, N) bf16.
extern "C" int plane_lut_matmul(const void* x, const void* words,
                                const void* scale, const void* bias,
                                const void* lut, void* out, int M, int N,
                                int K, int kw, int nbits, int ksize,
                                float step, float zero, void* stream) {
  Args g{static_cast<const bf16*>(x), static_cast<const int*>(words),
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         static_cast<const float*>(lut), static_cast<bf16*>(out), M, N, K,
         kw, ksize, 1.0f, 0.0f, step, zero};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return launch_m<1, true>(g, s);
    case 2: return launch_m<2, true>(g, s);
    case 3: return launch_m<3, true>(g, s);
    case 4: return launch_m<4, true>(g, s);
    case 8: return launch_m<8, true>(g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K9. Arguments as K8 without the table; a = step * 2^nbits and b the
// rowsum coefficient of the fold over C - 1.5 (zero + step/2).
extern "C" int plane_affine_matmul(const void* x, const void* words,
                                   const void* scale, const void* bias,
                                   void* out, int M, int N, int K, int kw,
                                   int nbits, float a, float b,
                                   void* stream) {
  Args g{static_cast<const bf16*>(x), static_cast<const int*>(words),
         static_cast<const float*>(scale), static_cast<const float*>(bias),
         nullptr, static_cast<bf16*>(out), M, N, K, kw, 0, a, b, 0.0f, 0.0f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nbits) {
    case 1: return launch_m<1, false>(g, s);
    case 2: return launch_m<2, false>(g, s);
    case 3: return launch_m<3, false>(g, s);
    case 4: return launch_m<4, false>(g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
