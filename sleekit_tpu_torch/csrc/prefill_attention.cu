// Kernel K4 of the port: causal flash attention for prefill.
//
// Replaces: sleekit_tpu/ops/attention.py  flash_prefill_pallas /
// _prefill_kernel.
//
// q (B, T, H, D), k/v (B, KV, T, D) in bf16 or f32; out (B, T, H, D) =
// softmax(q k^T * scale [+ slope_h * (col - row)], col <= row) v, where
// q head h reads KV head h / (H / KV) in place (no GQA repeat).
//
// What bounds it on an H100: at the serving prompt buckets (T = 256,
// D = 64) neither bound is large - q, k, v and out are 4 MB at batch 8,
// and the causal products are about 2*T*T*D*H*B/2 = 2.1 GFLOP per layer -
// so the card's time goes to the products on the CUDA cores.
//
// What the design does about it: one block per (64-row T block, q head,
// batch row) keeps its q tile in shared memory and streams 64-row K/V
// chunks only up to its causal limit (the masked upper triangle is never
// loaded); each thread computes a 4x4 tile of logits and a 4x(D/16) tile
// of p @ V from 16-byte shared-memory loads, and the online softmax keeps
// f32 running maxima and sums per row, with p rounded to the compute dtype
// before p @ V as the TPU kernel does. Simple first version: CUDA-core
// FMAs, no tensor cores, no TMA.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BT = 64;   // query rows per block
constexpr int BS = 64;   // key rows per chunk
constexpr int KP = BS + 4;  // padded row length of the transposed K tile
constexpr int PP = BT + 4;  // padded row length of the transposed p tile

template <typename T>
__global__ void __launch_bounds__(THREADS) prefill_kernel(
    const T* q, const T* k, const T* v, const float* slopes, T* out, int Tn,
    int H, int KV, int D, float scale) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // (D, BT) q, transposed
  float* kt = qt + D * BT;                       // (D, KP) k chunk, transposed
  float* vs = kt + D * KP;                       // (BS, D) v chunk
  float* ss = vs + BS * D;                       // (BT, KP) logits
  float* ps = ss + BT * KP;                      // (BS, PP) p, transposed
  float* mrow = ps + BS * PP;                    // (BT,) running max
  float* lrow = mrow + BT;                       // (BT,) running sum
  float* arow = lrow + BT;                       // (BT,) rescale factor

  const int tb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int r0 = tb * BT;
  const float slope = slopes ? slopes[h] : 0.0f;

  for (int i = tid; i < BT * D; i += THREADS) {
    const int r = i / D, d = i % D, row = r0 + r;
    qt[d * BT + r] =
        row < Tn ? to_f(q[(((size_t)b * Tn + row) * H + h) * D + d]) : 0.0f;
  }
  for (int i = tid; i < BT; i += THREADS) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.0f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const size_t kv0 = ((size_t)b * KV + kvh) * Tn * D;
  const int limit = min(r0 + BT, Tn);  // first column no row here attends
  for (int c0 = 0; c0 < limit; c0 += BS) {
    __syncthreads();
    for (int i = tid; i < BS * D; i += THREADS) {
      const int s = i / D, d = i % D, col = c0 + s;
      float kv = 0.0f, vv = 0.0f;
      if (col < Tn) {
        kv = to_f(k[kv0 + (size_t)col * D + d]);
        vv = to_f(v[kv0 + (size_t)col * D + d]);
      }
      kt[d * KP + s] = kv;
      vs[s * D + d] = vv;
    }
    __syncthreads();
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + d * BT + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kt + d * KP + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kw[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] += qv[i] * kw[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = r0 + ty * 4 + i, col = c0 + tx * 4 + j;
        float l = sacc[i][j] * scale;
        if (slopes) l += slope * (float)(col - row);
        if (col > row || col >= Tn) l = -INFINITY;
        ss[(ty * 4 + i) * KP + tx * 4 + j] = l;
      }
    __syncthreads();
    {  // online softmax: four threads per row, 16 columns each
      const int r = tid / 4, part = tid % 4;
      const float* sr = ss + r * KP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 16; ++i) mx = fmaxf(mx, sr[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = mrow[r], m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float e = expf(sr[i] - m_new);
        sum += e;
        ps[(part * 16 + i) * PP + r] = BF ? round_bf16(e) : e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        mrow[r] = m_new;
        lrow[r] = lrow[r] * alpha + sum;
        arow[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = arow[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= al;
    }
    for (int s = 0; s < BS; ++s) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + s * PP + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int d0 = jj * 64 + tx * 4;
        if (d0 >= D) break;
        const float4 vb = *reinterpret_cast<const float4*>(vs + s * D + d0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj * 4 + 0] += pv[i] * vb.x;
          acc[i][jj * 4 + 1] += pv[i] * vb.y;
          acc[i][jj * 4 + 2] += pv[i] * vb.z;
          acc[i][jj * 4 + 3] += pv[i] * vb.w;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = r0 + r;
    if (row >= Tn) continue;
    const float l = lrow[r];
    T* o = out + (((size_t)b * Tn + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = jj * 64 + tx * 4 + j;
        if (d < D) o[d] = from_f<T>(acc[i][jj * 4 + j] / l);
      }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* slopes,
           void* out, int B, int Tn, int H, int KV, int D, float scale,
           cudaStream_t stream) {
  const int bytes =
      4 * (D * BT + D * KP + BS * D + BT * KP + BS * PP + 3 * BT);
  static bool raised = false;
  cudaError_t err = allow_smem(prefill_kernel<T>, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tn + BT - 1) / BT, H, B);
  prefill_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), slopes, static_cast<T*>(out), Tn, H, KV, D,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, H, D), k/v (B, KV, T, D), out (B, T, H, D), all bf16 (is_bf16)
// or all f32; D % 4 == 0 and D <= 128; slopes (H,) f32 or null.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* slopes, void* out, int B, int T,
                             int H, int KV, int D, float scale, int is_bf16,
                             void* stream) {
  if (D % 4 != 0 || D > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  return is_bf16 ? launch<bf16>(q, k, v, sl, out, B, T, H, KV, D, scale, s)
                 : launch<float>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
}
