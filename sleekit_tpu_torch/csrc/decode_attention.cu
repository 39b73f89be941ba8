// Kernel K3 of the port: fused KV append + flash decode, one decode step of
// one layer.
//
// Replaces: sleekit_tpu/ops/attention.py  fused_decode_append_pallas /
// _fused_decode_kernel_impl.
//
// It writes the new token's K/V (B, KV, D) into the (L, B, KV, S, D) cache
// at pos (a scalar or a (B,) vector, clamped to S-1) - int8 caches quantize
// it first with a symmetric per-(token, head) scale (round half to even,
// x / scale exactly: no fast math) stored as bf16 or f32 - and returns
// softmax(q k^T * scale [+ slope * (s - pos)]) v over s <= pos, with GQA
// (q head h*G + g reads KV head h).
//
// What bounds it on an H100: the cache rows it must read, (pos+1) * D
// bytes of int8 K and V plus their scales per (batch row, KV head) - at
// OPT-1.3B batch 8, pos 256 about 8.4 MB per layer - over device memory.
//
// What the design does about it: one block per (KV head, batch row) reads
// only the rows s < pos, once; the block serves all G query heads of its
// KV head from one read. The new token's logit and value come from
// registers and shared memory (it is quantized in the block), so the
// stale row at pos is never read, and exactly one thread writes the token
// row and its scale, after the block's last read. Softmax is online over
// chunks of 128 rows (f32 running max and sum), with p rounded to the
// compute dtype before p @ V as the TPU kernel does. Simple first version:
// one thread per logit along D, no tensor cores, no split over S.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int CS = 128;  // cache rows per chunk

template <typename QT, typename CT, typename ST, bool QUANT>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const QT* q, const QT* k_new, const QT* v_new, CT* cache_k, CT* cache_v,
    ST* k_scale, ST* v_scale, const float* slopes, const int* pos_ptr,
    QT* out, int pos_scalar, int layer, int B, int KV, int G, int S, int D,
    float scale) {
  constexpr bool BF = std::is_same<QT, bf16>::value;  // compute dtype bf16
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (G, D) q
  float* acc = qs + G * D;                       // (G, D) running p @ V
  float* lg = acc + G * D;                       // (G, CS) logits, then p
  float* tok = lg + G * CS;                      // (2, D) new token K, V
  float* st = tok + 2 * D;  // (5, G): max, sum, alpha, token logit, token p
  __shared__ float tok_scale[2];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int p = pos_ptr ? pos_ptr[b] : pos_scalar;
  p = min(max(p, 0), S - 1);
  const size_t row0 = (((size_t)layer * B + b) * KV + h) * S;
  const CT* kc = cache_k + row0 * D;
  const CT* vc = cache_v + row0 * D;
  const QT* kn = k_new + ((size_t)b * KV + h) * D;
  const QT* vn = v_new + ((size_t)b * KV + h) * D;
  const size_t q0 = ((size_t)b * KV * G + (size_t)h * G) * D;
  constexpr int VEC = 16 / sizeof(CT);
  const bool vec_rows = D % VEC == 0 && (uintptr_t)cache_k % 16 == 0;

  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = to_f(q[q0 + i]);
    acc[i] = 0.0f;
  }
  // The new token in the compute dtype; int8 caches quantize it here.
  if constexpr (QUANT) {
    if (warp < 2) {
      const QT* src = warp == 0 ? kn : vn;
      float amax = 0.0f;
      for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f(src[d])));
      const float sc = fmaxf(warp_max(amax) / 127.0f, 1e-8f);
      for (int d = lane; d < D; d += 32)
        tok[warp * D + d] = fminf(fmaxf(rintf(to_f(src[d]) / sc), -127.0f),
                                  127.0f);
      // The token's scale round-trips the stored scale dtype first.
      if (lane == 0) tok_scale[warp] = to_f(from_f<ST>(sc));
    }
  } else {
    for (int i = tid; i < 2 * D; i += THREADS) {
      const QT* src = i < D ? kn : vn;
      const float v = to_f(from_f<CT>(to_f(src[i % D])));
      tok[i] = BF ? round_bf16(v) : v;
    }
    if (tid == 0) tok_scale[0] = tok_scale[1] = 1.0f;
  }
  __syncthreads();
  for (int g = warp; g < G; g += NWARPS) {
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += qs[g * D + d] * tok[d];
    s = warp_sum(s);
    if (lane == 0) {
      float nl = s * scale;
      if constexpr (QUANT) nl *= tok_scale[0];
      st[g] = -INFINITY;
      st[G + g] = 0.0f;
      st[3 * G + g] = nl;  // ALiBi distance of the token is 0
    }
  }

  const int nchunks = max(1, (p + CS - 1) / CS);  // cached rows s < p
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * CS, cs = min(CS, p - s0);
    __syncthreads();
    for (int i = tid; i < G * CS; i += THREADS) {
      const int g = i / CS, s = i % CS;
      float l = -INFINITY;
      if (s < cs) {
        const CT* kr = kc + (size_t)(s0 + s) * D;
        const float* qg = qs + g * D;
        float dot = 0.0f;
        if (vec_rows) {  // 16-byte loads of the key row
#pragma unroll 4
          for (int d0 = 0; d0 < D; d0 += VEC) {
            const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kr + d0));
            const CT* e = reinterpret_cast<const CT*>(&raw);
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              float kv = to_f(e[j]);
              if (BF && !QUANT) kv = round_bf16(kv);
              dot += qg[d0 + j] * kv;
            }
          }
        } else {
          for (int d = 0; d < D; ++d) {
            float kv = to_f(kr[d]);
            if (BF && !QUANT) kv = round_bf16(kv);
            dot += qg[d] * kv;
          }
        }
        l = dot * scale;
        if constexpr (QUANT) l *= to_f(k_scale[row0 + s0 + s]);
        if (slopes) l += slopes[h * G + g] * (float)(s0 + s - p);
      }
      lg[i] = l;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARPS) {
      float* lr = lg + g * CS;
      float mx = -INFINITY;
      for (int s = lane; s < CS; s += 32) mx = fmaxf(mx, lr[s]);
      mx = warp_max(mx);
      const float nl = st[3 * G + g];
      if (c == 0) mx = fmaxf(mx, nl);
      const float m_old = st[g], m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f;
      for (int s = lane; s < CS; s += 32) {
        float e = 0.0f;
        if (s < cs) {
          e = expf(lr[s] - m_new);
          sum += e;
          if constexpr (QUANT) e *= to_f(v_scale[row0 + s0 + s]);
        }
        lr[s] = BF ? round_bf16(e) : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        float pt = 0.0f;
        if (c == 0) {
          const float e = expf(nl - m_new);
          sum += e;
          pt = e * tok_scale[1];
          pt = BF ? round_bf16(pt) : pt;
        }
        st[g] = m_new;
        st[G + g] = st[G + g] * alpha + sum;
        st[2 * G + g] = alpha;
        st[4 * G + g] = pt;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      const float* pr = lg + g * CS;
      float sv = 0.0f;
#pragma unroll 8
      for (int s = 0; s < cs; ++s) {
        float vv = to_f(vc[(size_t)(s0 + s) * D + d]);
        if (BF && !QUANT) vv = round_bf16(vv);
        sv += pr[s] * vv;
      }
      acc[i] = acc[i] * st[2 * G + g] + sv + st[4 * G + g] * tok[D + d];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS)
    out[q0 + i] = from_f<QT>(acc[i] / st[G + i / D]);
  // Exactly one thread persists the token row (and its scales) at p; no
  // thread of any block reads row p.
  if (tid == 0) {
    CT* kw = cache_k + (row0 + p) * D;
    CT* vw = cache_v + (row0 + p) * D;
    if constexpr (QUANT) {
      for (int d = 0; d < D; ++d) {
        kw[d] = (int8_t)tok[d];
        vw[d] = (int8_t)tok[D + d];
      }
      k_scale[row0 + p] = from_f<ST>(tok_scale[0]);
      v_scale[row0 + p] = from_f<ST>(tok_scale[1]);
    } else {
      for (int d = 0; d < D; ++d) {
        kw[d] = from_f<CT>(to_f(kn[d]));
        vw[d] = from_f<CT>(to_f(vn[d]));
      }
    }
  }
}

struct Launch {
  const void *q, *k_new, *v_new;
  void *cache_k, *cache_v, *k_scale, *v_scale;
  const float* slopes;
  const int* pos;
  void* out;
  int pos_scalar, layer, B, KV, G, S, D;
  float scale;
};

template <typename QT, typename CT, typename ST, bool QUANT>
int launch(const Launch& a, cudaStream_t stream) {
  const int bytes = 4 * (2 * a.G * a.D + a.G * CS + 2 * a.D + 5 * a.G);
  static bool raised = false;
  cudaError_t err = allow_smem(decode_kernel<QT, CT, ST, QUANT>, bytes,
                               &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.KV, a.B);
  decode_kernel<QT, CT, ST, QUANT><<<grid, THREADS, bytes, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const QT*>(a.k_new),
      static_cast<const QT*>(a.v_new), static_cast<CT*>(a.cache_k),
      static_cast<CT*>(a.cache_v), static_cast<ST*>(a.k_scale),
      static_cast<ST*>(a.v_scale), a.slopes, a.pos, static_cast<QT*>(a.out),
      a.pos_scalar, a.layer, a.B, a.KV, a.G, a.S, a.D, a.scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_q(const Launch& a, int cache_kind, int scale_bf16,
             cudaStream_t s) {
  switch (cache_kind) {
    case 0:
      return scale_bf16 ? launch<QT, int8_t, bf16, true>(a, s)
                        : launch<QT, int8_t, float, true>(a, s);
    case 1: return launch<QT, bf16, float, false>(a, s);
    case 2: return launch<QT, float, float, false>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H = KV*G, D) bf16/f32; k_new/v_new (B, KV, D) in q's dtype; caches
// (L, B, KV, S, D) int8 (cache_kind 0, with (L, B, KV, S) bf16/f32 scale
// planes), bf16 (1) or f32 (2); slopes (H,) f32 or null; pos (B,) int32 or
// null (then pos_scalar); out (B, H, D) in q's dtype.
extern "C" int fused_decode_append(
    const void* q, const void* k_new, const void* v_new, void* cache_k,
    void* cache_v, void* k_scale, void* v_scale, const void* slopes,
    const void* pos, void* out, int pos_scalar, int layer, int L, int B,
    int KV, int G, int S, int D, float scale, int q_bf16, int cache_kind,
    int scale_bf16, void* stream) {
  (void)L;
  Launch a{q, k_new, v_new, cache_k, cache_v, k_scale, v_scale,
           static_cast<const float*>(slopes), static_cast<const int*>(pos),
           out, pos_scalar, layer, B, KV, G, S, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_q<bf16>(a, cache_kind, scale_bf16, s)
                : launch_q<float>(a, cache_kind, scale_bf16, s);
}
