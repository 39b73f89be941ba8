// Kernels K3, K5, K11, K12, K13 and K15 of the port: flash decode over the
// KV cache, one decode step of one layer, with or without the append of
// the new token, over a slot cache or a page pool.
//
// Replaces: sleekit_tpu/ops/attention.py  fused_decode_append_pallas /
// _fused_decode_kernel_impl (K3) and flash_decode_pallas with its three
// bodies, _decode_kernel (K11), _decode_kernel_ew (K12, mha_mode='ew' at
// G = 1) and _decode_kernel_bfold (K13, batch_fold);
// sleekit_tpu/ops/paged_attention.py paged_fused_decode_append_pallas (K5)
// and paged_flash_decode_pallas (K15).
//
// The cache is addressed by a row rule. A page pool (L, P, KV, PS, D) with
// a table (B, MAXP) int32 holds logical row s of batch row b in physical
// page table[b, s / PS], row s % PS; a slot cache (L, B, KV, S, D) is the
// same layout with P = B, PS = S and the table left out (page b). Int8
// caches keep a per-(token, head) scale in planes (L, P, KV, PS) read by
// the same rule. pos is a scalar or a (B,) vector, clamped to MAXP*PS - 1.
//
// The fused entry (K3, K5) writes the new token's K/V (B, KV, D) at pos -
// int8 caches quantize it first with a symmetric per-(token, head) scale
// (round half to even, x / scale exactly: no fast math) stored as bf16 or
// f32 - and returns softmax(q k^T * scale [+ slope * (s - pos)]) v over
// s <= pos, with GQA (q head h*G + g reads KV head h). The flash-decode
// entry (K11, K15) does the same over the cached rows s <= pos, with no
// append. K12 is K11's function under the TPU's elementwise MHA numerics,
// all f32: nothing is rounded to bf16 but the output, and an int8 key's
// scale multiplies the key before the dot (K11 scales the logit). K13 is
// K11 with the batch folded into each block: the TPU kernel runs all B
// rows in one program per KV chunk, here one block per KV head walks every
// batch row, one group of 128 threads per row.
//
// What bounds it on an H100: the cache rows it must read, (pos+1) * D
// bytes of int8 K and V plus their scales per (batch row, KV head) - at
// OPT-1.3B batch 8, pos 256 about 8.4 MB per layer - over device memory.
//
// What the design does about it: one block (or, in K13, one group of a
// block) per (KV head, batch row) reads only the rows it needs (s < pos
// fused, s <= pos otherwise), once; it serves all G query heads of its KV
// head from one read, and table entries past page pos / PS are never
// read. It walks LOGICAL rows in chunks of 128 whatever the page size, so
// the floating-point work and its order do not depend on the layout or on
// the grid: K5's output and written bytes equal K3's, and K13's output
// equals K11's, on the same logical contents. K13's groups finish after
// different numbers of chunks, so each syncs on its own named barrier.
// Over a pool, each chunk first resolves its rows' addresses into shared
// memory; p @ V then walks the chunk one page segment at a time, so its
// loads stay affine in the row as over a slot cache, and each thread
// issues the loads of 16 value rows (4 of a key row) before it uses them:
// left to itself, the compiler interleaved each load with its product over
// a pool, one memory latency per row, and K15 took 4x K11's time on an
// H100 at OPT-1.3B decode shapes. (The same batching made K3 19% slower
// there, so the slot rule keeps K3's loops.) In the fused kernel the new
// token's logit and value come from registers and shared memory (it is
// quantized in the block), so the stale row at pos is never read, and
// exactly one thread writes the token row and its scale, after the block's
// last read. Softmax is online over the chunks (f32 running max and sum),
// with p rounded to the compute dtype before p @ V as the TPU kernel does
// (not in K12). Simple first version: one thread per logit along D, no
// tensor cores, no split over S.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // threads per (KV head, batch row)
constexpr int NWARPS = THREADS / 32;
constexpr int CS = 128;  // cache rows per chunk
constexpr int LD = 4;    // 16-byte loads of a key row in flight
constexpr int LV = 16;   // value rows' loads in flight per thread
constexpr int MAX_GROUPS = 8;  // K13: batch rows a block decodes at once
static_assert(THREADS >= CS, "one thread resolves each row of a chunk");

// The schedules of the flash-decode body.
enum Mode { FUSED_APPEND, FLASH, FLASH_EW, FLASH_BFOLD };

// Where the cache keeps logical row s of (layer, batch row b, KV head h),
// in rows of D elements (or in elements of a scale plane).
struct Rows {
  const int* table;  // (B, MAXP) int32, or null for a slot cache
  int layer, P, KV, PS, MAXP;

  __device__ __forceinline__ size_t at(int b, int h, int s) const {
    const int page = table ? table[b * MAXP + s / PS] : b;
    return (((size_t)layer * P + page) * KV + h) * PS + s % PS;
  }
};

// Floats of shared memory one (KV head, batch row) uses: q, the running
// p @ V, one chunk's logits, the new token's K and V, five (G,) stats.
__host__ __device__ __forceinline__ int row_floats(int G, int D) {
  return 2 * G * D + G * CS + 2 * D + 5 * G;
}

// One block per (KV head, batch row) (K3, K5, K11, K12, K15), or (K13,
// FLASH_BFOLD) one block per KV head whose group j of THREADS threads
// decodes batch rows j, j + groups, ... and syncs on its own named
// barrier, since its rows end after different numbers of chunks. PAGED:
// rows.table is set (K5, K15); else the slot rule.
template <typename QT, typename CT, typename ST, bool QUANT, int MODE,
          bool PAGED>
__global__ void __launch_bounds__(MODE == FLASH_BFOLD ? MAX_GROUPS * THREADS
                                                      : THREADS)
    decode_kernel(const QT* q, const QT* k_new, const QT* v_new,
                  CT* cache_k, CT* cache_v, ST* k_scale, ST* v_scale,
                  const float* slopes, const int* pos_ptr, QT* out,
                  Rows rows, int pos_scalar, int B, int G, int D,
                  float scale) {
  constexpr bool FUSED = MODE == FUSED_APPEND;
  constexpr bool EW = MODE == FLASH_EW;
  constexpr bool FOLD = MODE == FLASH_BFOLD;
  // bf16 compute: q, K, V and p rounded to bf16 (never in K12).
  constexpr bool BF = std::is_same<QT, bf16>::value && !EW;
  const int j = FOLD ? threadIdx.x / THREADS : 0;  // this thread's group
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4) + j * row_floats(G, D);
  float* acc = qs + G * D;   // (G, D) running p @ V
  float* lg = acc + G * D;   // (G, CS) logits, then p
  float* tok = lg + G * CS;  // (2, D) new token K, V
  float* st = tok + 2 * D;   // (5, G): max, sum, alpha, token logit, token p
  __shared__ float tok_scale[2];
  __shared__ size_t roff[PAGED ? CS : 1];  // this chunk's row addresses
  auto sync = [j] {
    if constexpr (FOLD)
      asm volatile("bar.sync %0, %1;" ::"r"(1 + j), "r"(THREADS) : "memory");
    else
      __syncthreads();
  };

  const int h = blockIdx.x, KV = rows.KV, PS = rows.PS;
  const int tid = FOLD ? threadIdx.x % THREADS : threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // K13's group j decodes rows j, j + groups, ...; the other kernels one
  // row, a loop of one trip the compiler removes.
  const int groups = FOLD ? blockDim.x / THREADS : 1;
  const int n_rows = FOLD ? (B - j + groups - 1) / groups : 1;
  for (int row = 0; row < n_rows; ++row) {
    const int b = FOLD ? j + row * groups : blockIdx.y;
    if (FOLD && row > 0) sync();  // the last row's reads of smem are done
    int p = pos_ptr ? pos_ptr[b] : pos_scalar;
    p = min(max(p, 0), rows.MAXP * PS - 1);
    // Row of logical row 0 under the slot rule (page b).
    const size_t slot0 = PAGED ? 0 : rows.at(b, h, 0);
    const size_t q0 = ((size_t)b * KV * G + (size_t)h * G) * D;
    constexpr int VEC = 16 / sizeof(CT);
    const bool vec_rows = D % VEC == 0 && (uintptr_t)cache_k % 16 == 0;

    for (int i = tid; i < G * D; i += THREADS) {
      qs[i] = to_f(q[q0 + i]);
      acc[i] = 0.0f;
    }
    if constexpr (FUSED) {
      const QT* kn = k_new + ((size_t)b * KV + h) * D;
      const QT* vn = v_new + ((size_t)b * KV + h) * D;
      // The new token in the compute dtype; int8 caches quantize it here.
      if constexpr (QUANT) {
        if (warp < 2) {
          const QT* src = warp == 0 ? kn : vn;
          float amax = 0.0f;
          for (int d = lane; d < D; d += 32)
            amax = fmaxf(amax, fabsf(to_f(src[d])));
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
      sync();
    }
    for (int g = warp; g < G; g += NWARPS) {
      float nl = 0.0f;
      if constexpr (FUSED) {
        float s = 0.0f;
        for (int d = lane; d < D; d += 32) s += qs[g * D + d] * tok[d];
        s = warp_sum(s);
        nl = s * scale;
        if constexpr (QUANT) nl *= tok_scale[0];
      }
      if (lane == 0) {
        st[g] = -INFINITY;
        st[G + g] = 0.0f;
        st[3 * G + g] = nl;  // ALiBi distance of the token is 0
        st[4 * G + g] = 0.0f;
      }
    }

    // Cached rows read: s < p when the token comes from registers, else
    // s <= p.
    const int n = FUSED ? p : p + 1;
    const int nchunks = max(1, (n + CS - 1) / CS);
    for (int c = 0; c < nchunks; ++c) {
      const int s0 = c * CS, cs = min(CS, n - s0);
      if constexpr (PAGED) {
        sync();
        if (tid < cs) roff[tid] = rows.at(b, h, s0 + tid);
      }
      sync();
      for (int i = tid; i < G * CS; i += THREADS) {
        const int g = i / CS, s = i % CS;
        float l = -INFINITY;
        if (s < cs) {
          const size_t r = PAGED ? roff[s] : slot0 + s0 + s;
          const CT* kr = cache_k + r * D;
          const float* qg = qs + g * D;
          // K12 scales each key element before the dot, the others the
          // logit.
          float ksc = 1.0f;
          if constexpr (EW && QUANT) ksc = to_f(k_scale[r]);
          float dot = 0.0f;
          if (vec_rows && PAGED) {  // 16-byte loads, LD at a time
            for (int d1 = 0; d1 < D; d1 += LD * VEC) {
              uint4 raw[LD];
#pragma unroll
              for (int jj = 0; jj < LD; ++jj)
                if (d1 + jj * VEC < D)
                  raw[jj] = __ldg(reinterpret_cast<const uint4*>(kr + d1 +
                                                                 jj * VEC));
#pragma unroll
              for (int jj = 0; jj < LD; ++jj) {
                if (d1 + jj * VEC >= D) break;
                const CT* e = reinterpret_cast<const CT*>(&raw[jj]);
#pragma unroll
                for (int k = 0; k < VEC; ++k) {
                  float kv = to_f(e[k]);
                  if (BF && !QUANT) kv = round_bf16(kv);
                  if constexpr (EW && QUANT) kv *= ksc;
                  dot += qg[d1 + jj * VEC + k] * kv;
                }
              }
            }
          } else if (vec_rows) {  // 16-byte loads of the key row
#pragma unroll 4
            for (int d0 = 0; d0 < D; d0 += VEC) {
              const uint4 raw = __ldg(reinterpret_cast<const uint4*>(kr + d0));
              const CT* e = reinterpret_cast<const CT*>(&raw);
#pragma unroll
              for (int jj = 0; jj < VEC; ++jj) {
                float kv = to_f(e[jj]);
                if (BF && !QUANT) kv = round_bf16(kv);
                if constexpr (EW && QUANT) kv *= ksc;
                dot += qg[d0 + jj] * kv;
              }
            }
          } else {
            for (int d = 0; d < D; ++d) {
              float kv = to_f(kr[d]);
              if (BF && !QUANT) kv = round_bf16(kv);
              if constexpr (EW && QUANT) kv *= ksc;
              dot += qg[d] * kv;
            }
          }
          l = dot * scale;
          if constexpr (QUANT && !EW) l *= to_f(k_scale[r]);
          if (slopes) l += slopes[h * G + g] * (float)(s0 + s - p);
        }
        lg[i] = l;
      }
      sync();
      for (int g = warp; g < G; g += NWARPS) {
        float* lr = lg + g * CS;
        float mx = -INFINITY;
        for (int s = lane; s < CS; s += 32) mx = fmaxf(mx, lr[s]);
        mx = warp_max(mx);
        const float nl = st[3 * G + g];
        if (FUSED && c == 0) mx = fmaxf(mx, nl);
        const float m_old = st[g], m_new = fmaxf(m_old, mx);
        const float alpha = expf(m_old - m_new);
        float sum = 0.0f;
        for (int s = lane; s < CS; s += 32) {
          float e = 0.0f;
          if (s < cs) {
            e = expf(lr[s] - m_new);
            sum += e;
            if constexpr (QUANT)
              e *= to_f(v_scale[PAGED ? roff[s] : slot0 + s0 + s]);
          }
          lr[s] = BF ? round_bf16(e) : e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          float pt = 0.0f;
          if (FUSED && c == 0) {
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
      sync();
      for (int i = tid; i < G * D; i += THREADS) {
        const int g = i / D, d = i % D;
        const float* pr = lg + g * CS;
        float sv = 0.0f;
        if constexpr (PAGED) {
          // One page segment [sa, sb) of the chunk at a time, s ascending as
          // under the slot rule; LV rows' loads issued together, then their
          // products in order.
          for (int sa = 0; sa < cs;) {
            const int sb = min(cs, sa + PS - (s0 + sa) % PS);
            const CT* vr = cache_v + roff[sa] * D + d;
            int s = sa;
            for (; s + LV <= sb; s += LV) {
              float vv[LV];
#pragma unroll
              for (int jj = 0; jj < LV; ++jj)
                vv[jj] = to_f(vr[(size_t)(s - sa + jj) * D]);
#pragma unroll
              for (int jj = 0; jj < LV; ++jj) {
                if (BF && !QUANT) vv[jj] = round_bf16(vv[jj]);
                sv += pr[s + jj] * vv[jj];
              }
            }
            for (; s < sb; ++s) {
              float vv = to_f(vr[(size_t)(s - sa) * D]);
              if (BF && !QUANT) vv = round_bf16(vv);
              sv += pr[s] * vv;
            }
            sa = sb;
          }
        } else if constexpr (!FUSED) {
          // The flash-decode kernels batch LV rows' loads as over a pool,
          // the products in the same order: left to itself, the compiler
          // changed its choice with unrelated edits of this file, and K11
          // took 0.038 ms instead of 0.027 on an H100 at OPT-1.3B pos 256
          // until the loads were batched here.
          const CT* vr = cache_v + (slot0 + s0) * D + d;
          int s = 0;
          for (; s + LV <= cs; s += LV) {
            float vv[LV];
#pragma unroll
            for (int jj = 0; jj < LV; ++jj)
              vv[jj] = to_f(vr[(size_t)(s + jj) * D]);
#pragma unroll
            for (int jj = 0; jj < LV; ++jj) {
              if (BF && !QUANT) vv[jj] = round_bf16(vv[jj]);
              sv += pr[s + jj] * vv[jj];
            }
          }
          for (; s < cs; ++s) {
            float vv = to_f(vr[(size_t)s * D]);
            if (BF && !QUANT) vv = round_bf16(vv);
            sv += pr[s] * vv;
          }
        } else {
          const CT* vr = cache_v + (slot0 + s0) * D + d;
#pragma unroll 8
          for (int s = 0; s < cs; ++s) {
            float vv = to_f(vr[(size_t)s * D]);
            if (BF && !QUANT) vv = round_bf16(vv);
            sv += pr[s] * vv;
          }
        }
        float a = acc[i] * st[2 * G + g] + sv;
        if constexpr (FUSED) a += st[4 * G + g] * tok[D + d];
        acc[i] = a;
      }
    }
    sync();
    for (int i = tid; i < G * D; i += THREADS)
      out[q0 + i] = from_f<QT>(acc[i] / st[G + i / D]);
    if constexpr (FUSED) {
      // Exactly one thread persists the token row (and its scales) at p; no
      // thread of any block reads row p.
      if (tid == 0) {
        const size_t r = rows.at(b, h, p);
        CT* kw = cache_k + r * D;
        CT* vw = cache_v + r * D;
        if constexpr (QUANT) {
          for (int d = 0; d < D; ++d) {
            kw[d] = (int8_t)tok[d];
            vw[d] = (int8_t)tok[D + d];
          }
          k_scale[r] = from_f<ST>(tok_scale[0]);
          v_scale[r] = from_f<ST>(tok_scale[1]);
        } else {
          const QT* kn = k_new + ((size_t)b * KV + h) * D;
          const QT* vn = v_new + ((size_t)b * KV + h) * D;
          for (int d = 0; d < D; ++d) {
            kw[d] = from_f<CT>(to_f(kn[d]));
            vw[d] = from_f<CT>(to_f(vn[d]));
          }
        }
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
  Rows rows;
  int pos_scalar, B, G, D;
  float scale;
};

template <typename QT, typename CT, typename ST, bool QUANT, int MODE,
          bool PAGED>
int launch_rule(const Launch& a, cudaStream_t stream) {
  // K13: one block per KV head, a group of THREADS per batch row (up to
  // MAX_GROUPS rows at once); the others one block per (KV head, row).
  const int groups = MODE == FLASH_BFOLD ? min(a.B, MAX_GROUPS) : 1;
  const int bytes = 4 * row_floats(a.G, a.D) * groups;
  static bool raised = false;
  cudaError_t err = allow_smem(
      decode_kernel<QT, CT, ST, QUANT, MODE, PAGED>, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = MODE == FLASH_BFOLD ? dim3(a.rows.KV)
                                        : dim3(a.rows.KV, a.B);
  decode_kernel<QT, CT, ST, QUANT, MODE, PAGED>
      <<<grid, groups * THREADS, bytes, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const QT*>(a.k_new),
      static_cast<const QT*>(a.v_new), static_cast<CT*>(a.cache_k),
      static_cast<CT*>(a.cache_v), static_cast<ST*>(a.k_scale),
      static_cast<ST*>(a.v_scale), a.slopes, a.pos, static_cast<QT*>(a.out),
      a.rows, a.pos_scalar, a.B, a.G, a.D, a.scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT, typename ST, bool QUANT, int MODE>
int launch(const Launch& a, cudaStream_t stream) {
  if constexpr (MODE == FUSED_APPEND || MODE == FLASH) {
    if (a.rows.table)
      return launch_rule<QT, CT, ST, QUANT, MODE, true>(a, stream);
  } else if (a.rows.table) {
    return (int)cudaErrorInvalidValue;  // K12 and K13 read a slot cache
  }
  return launch_rule<QT, CT, ST, QUANT, MODE, false>(a, stream);
}

template <typename QT, int MODE>
int launch_q(const Launch& a, int cache_kind, int scale_bf16,
             cudaStream_t s) {
  switch (cache_kind) {
    case 0:
      return scale_bf16 ? launch<QT, int8_t, bf16, true, MODE>(a, s)
                        : launch<QT, int8_t, float, true, MODE>(a, s);
    case 1: return launch<QT, bf16, float, false, MODE>(a, s);
    case 2: return launch<QT, float, float, false, MODE>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int MODE>
int flash_entry(const void* q, const void* cache_k, const void* cache_v,
                const void* k_scale, const void* v_scale, const void* slopes,
                const void* pos, const void* table, void* out, int pos_scalar,
                int layer, int B, int KV, int G, int P, int PS, int MAXP,
                int D, float scale, int q_bf16, int cache_kind,
                int scale_bf16, void* stream) {
  Launch a{q, nullptr, nullptr, const_cast<void*>(cache_k),
           const_cast<void*>(cache_v), const_cast<void*>(k_scale),
           const_cast<void*>(v_scale), static_cast<const float*>(slopes),
           static_cast<const int*>(pos), out,
           Rows{static_cast<const int*>(table), layer, P, KV, PS, MAXP},
           pos_scalar, B, G, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_q<bf16, MODE>(a, cache_kind, scale_bf16, s)
                : launch_q<float, MODE>(a, cache_kind, scale_bf16, s);
}

}  // namespace

// q (B, H = KV*G, D) bf16/f32; k_new/v_new (B, KV, D) in q's dtype; caches
// (L, P, KV, PS, D) int8 (cache_kind 0, with (L, P, KV, PS) bf16/f32 scale
// planes), bf16 (1) or f32 (2); table (B, MAXP) int32, or null for a slot
// cache (then P = B, PS = S, MAXP = 1); slopes (H,) f32 or null; pos (B,)
// int32 or null (then pos_scalar); out (B, H, D) in q's dtype.
extern "C" int fused_decode_append(
    const void* q, const void* k_new, const void* v_new, void* cache_k,
    void* cache_v, void* k_scale, void* v_scale, const void* slopes,
    const void* pos, const void* table, void* out, int pos_scalar, int layer,
    int B, int KV, int G, int P, int PS, int MAXP, int D, float scale,
    int q_bf16, int cache_kind, int scale_bf16, void* stream) {
  Launch a{q, k_new, v_new, cache_k, cache_v, k_scale, v_scale,
           static_cast<const float*>(slopes), static_cast<const int*>(pos),
           out, Rows{static_cast<const int*>(table), layer, P, KV, PS, MAXP},
           pos_scalar, B, G, D, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return q_bf16 ? launch_q<bf16, FUSED_APPEND>(a, cache_kind, scale_bf16, s)
                : launch_q<float, FUSED_APPEND>(a, cache_kind, scale_bf16, s);
}

// The same arguments without k_new/v_new: attention over the cached rows
// s <= pos, nothing written but out. flash_decode (K11, K15); the slot
// cache only: flash_decode_ew (K12, G = 1) and flash_decode_bfold (K13).
#define FLASH_ENTRY(name, mode)                                              \
  extern "C" int name(const void* q, const void* cache_k,                   \
                      const void* cache_v, const void* k_scale,             \
                      const void* v_scale, const void* slopes,              \
                      const void* pos, const void* table, void* out,        \
                      int pos_scalar, int layer, int B, int KV, int G, int P, \
                      int PS, int MAXP, int D, float scale, int q_bf16,     \
                      int cache_kind, int scale_bf16, void* stream) {       \
    return flash_entry<mode>(q, cache_k, cache_v, k_scale, v_scale, slopes, \
                             pos, table, out, pos_scalar, layer, B, KV, G, P, \
                             PS, MAXP, D, scale, q_bf16, cache_kind,        \
                             scale_bf16, stream);                           \
  }
FLASH_ENTRY(flash_decode, FLASH)
FLASH_ENTRY(flash_decode_ew, FLASH_EW)
FLASH_ENTRY(flash_decode_bfold, FLASH_BFOLD)
