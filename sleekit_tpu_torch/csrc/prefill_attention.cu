// Kernel K4 of the port: causal flash attention for prefill.
//
// Replaces: sleekit_tpu/ops/attention.py  flash_prefill_pallas /
// _prefill_kernel.
//
// q (B, T, H, D), k/v (B, KV, T, D) in bf16 or f32; out (B, T, H, D) =
// softmax(q k^T * scale [+ slope_h * (col - row)], col <= row) v, where
// q head h reads KV head h / (H / KV) in place (no GQA repeat). Logits,
// the running maxima and the running sums are f32; the sums take p
// unrounded, and p is rounded to the compute dtype before p @ V, over
// 64-row key chunks (BS, = _PREFILL_CHUNK of ops/attention.py, so the
// plain version rounds p against the same running maxima).
//
// What bounds it on an H100: at the serving prompt buckets it is the
// products. OPT-1.3B's 256-bucket group (B 4, T 256, H 32, D 64) moves
// 16.8 MB (5.0 us at 3.35 TB/s) for 1.08 GFLOP of causal products (1.1 us
// at 989 TFLOP/s); llama3-8b at T 1024 (D 128, 8 KV heads) 21 MB for 8.6
// GFLOP, where the operations bound. Products on the CUDA cores, through
// shared memory, run at about 1% of the tensor cores' rate, so the bf16
// route keeps both products on the tensor cores and every intermediate in
// registers.
//
// What the bf16 design does about it (prefill_mma_kernel<D>, D % 16 == 0,
// D <= 128): one block of 4 warps per (64-row q tile, q head, batch row),
// 16 q rows a warp, the heaviest causal tiles launched first (the tile
// index runs backwards on the slowest grid axis) so the one-chunk tiles
// fill the tail. q is loaded once into m16k16 A fragments (ldmatrix).
// 64-row K and V chunks stream through a two-stage cp.async ring (chunk
// c + 1 loads while chunk c computes), up to the tile's causal limit only,
// rows at or past T zero-filled. S = q k^T
// is mma.sync m16n8k16 with f32 accumulation, K's rows the .col B operand
// (ldmatrix without .trans); scale, ALiBi and (on the diagonal chunk
// alone) the mask are applied in registers; each row's max and sum live
// in the quad that holds it (__shfl_xor_sync 1, 2 for the max, the sum
// reduced once at the end). p, rounded to bf16, is P @ V's A operand
// straight from the registers (the C layout of two adjacent n8 tiles is
// the m16k16 A layout), V's B fragments by ldmatrix.trans. The output is
// divided by the row sum and staged through the warp's own q rows of
// shared memory, so it leaves in 16-byte stores.
//
// The f32 route (prefill_f32_kernel) keeps the CUDA-core body: tensor
// cores would compute in TF32, outside the f32 route's 1e-5 tolerance.
#include "common.cuh"

namespace {

constexpr int BT = 64;  // query rows per block
constexpr int BS = 64;  // key rows per chunk

// ---- bf16: the tensor-core route ---------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps of 16 q rows
constexpr int ST = 2;             // stages of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;

// The shared tiles of head dim D. LD is the padded row length (elements):
// rows lie an odd multiple of 16 bytes apart, so the 8 rows of an ldmatrix
// read fall in 8 distinct 16-byte bank groups. SMEM: q, then the ST stages
// of K and V, in bytes.
template <int D>
struct Tile {
  static constexpr int LD = D + 8;
  static constexpr int SMEM = (BT + 2 * ST * BS) * LD * 2;
};

// Rows row0 .. row0 + 63 of a (rows, D) matrix whose rows lie ``stride``
// elements apart into a padded tile, asynchronously; rows at or past Tn are
// zeros.
template <int D>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          size_t stride, int row0, int Tn,
                                          int tid) {
  constexpr int CP = D / 8;  // 16-byte pieces a row
#pragma unroll
  for (int j = 0; j < BS * CP / MMA_THREADS; ++j) {
    const int i = tid + j * MMA_THREADS, r = i / CP, c = i % CP;
    const bool ok = row0 + r < Tn;
    cp16(dst + r * Tile<D>::LD + c * 8,
         ok ? src + (size_t)(row0 + r) * stride + c * 8 : src, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ slopes,
    bf16* __restrict__ out, int Tn, int H, int KV, float scale) {
  constexpr int LD = Tile<D>::LD, DK = D / 16, DN = D / 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // (BT, LD) q, then the output
  bf16* ks = qs + BT * LD;                     // ST x (BS, LD)
  bf16* vs = ks + ST * BS * LD;                // ST x (BS, LD)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tb = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int r0 = tb * BT, n_chunks = tb + 1;  // chunks up to the causal limit
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_ld = (size_t)H * D;
  const bf16* qb = q + (size_t)b * Tn * q_ld + (size_t)h * D;
  const size_t kv0 = ((size_t)b * KV + h / (H / KV)) * Tn * D;
  const bf16* kb = k + kv0;
  const bf16* vb = v + kv0;
  const float slope = slopes ? slopes[h] : 0.0f;

  // One commit group a chunk (q rides with chunk 0); a group past the
  // causal limit is empty.
  copy_rows<D>(qs, qb, q_ld, r0, Tn, tid);
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < n_chunks) {
      copy_rows<D>(ks + c * BS * LD, kb, D, c * BS, Tn, tid);
      copy_rows<D>(vs + c * BS * LD, vb, D, c * BS, Tn, tid);
    }
    cp_commit();
  }

  uint32_t qf[DK][4];
  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  // This thread's two rows, g and g + 8 of the warp's 16: running max and
  // the sum of its own columns (the quad's sum is taken at the end).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int row0 = r0 + warp * 16 + g;

  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<ST - 2>();  // chunk c (and q) landed; later ones may be in flight
    __syncthreads();    // ... for every thread, and chunk c - 1 is consumed
    {  // chunk c + ST - 1 into the stage chunk c - 1 used
      const int cn = c + ST - 1, sn = cn % ST;
      if (cn < n_chunks) {
        copy_rows<D>(ks + sn * BS * LD, kb, D, cn * BS, Tn, tid);
        copy_rows<D>(vs + sn * BS * LD, vb, D, cn * BS, Tn, tid);
      }
      cp_commit();
    }
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                            8 * (lane / 16));
    }
    const bf16* kc = ks + (c % ST) * BS * LD;
    const bf16* vc = vs + (c % ST) * BS * LD;

    // S = q k^T: 16 rows x 64 keys a warp, eight n8 tiles.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // keys np*16 + (0..7 | 8..15) x d (0..7 | 8..15): B of tiles 2np,
        // 2np + 1
        uint32_t kf[4];
        ldsm_x4(kf, kc + (np * 16 + (lane / 16) * 8 + lane % 8) * LD +
                        kk * 16 + ((lane / 8) & 1) * 8);
        const uint32_t b0[2] = {kf[0], kf[1]}, b1[2] = {kf[2], kf[3]};
        mma_bf16(s[2 * np], qf[kk], b0);
        mma_bf16(s[2 * np + 1], qf[kk], b1);
      }

    // Logits in registers: element e of tile n is row row0 + 8 * (e / 2),
    // column c0 + 8n + 2t + e % 2. Only the diagonal (last) chunk holds a
    // column past its row, and a column at or past Tn lies past every row
    // that is stored, so col > row is the whole mask.
    const int c0 = c * BS;
    const bool diag = c == n_chunks - 1;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2), col = c0 + 8 * n + 2 * t + e % 2;
        float x = s[n][e] * scale;
        if (slopes) x += slope * (float)(col - row);
        if (diag && col > row) x = -INFINITY;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // Every row sees column 0 in chunk 0, so mx is finite.
      alpha[i] = exp2f((m[i] - mx[i]) * LOG2E);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[n][e] - m[e / 2]) * LOG2E);
        s[n][e] = p;
        l[e / 2] += p;  // unrounded p
      }
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += bf16(p) V: p's C tiles 2j, 2j + 1 are the A fragment of keys
    // 16j .. 16j + 15.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]),
          pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DK; ++dp) {
        // keys 16j + (0..7 | 8..15) x d dp*16 + (0..7 | 8..15), transposed:
        // B of d tiles 2dp, 2dp + 1
        uint32_t vf[4];
        ldsm_x4_trans(vf, vc + (j * 16 + ((lane / 8) & 1) * 8 + lane % 8) * LD +
                              dp * 16 + (lane / 16) * 8);
        const uint32_t b0[2] = {vf[0], vf[1]}, b1[2] = {vf[2], vf[3]};
        mma_bf16(o[2 * dp], pa, b0);
        mma_bf16(o[2 * dp + 1], pa, b1);
      }
    }
  }

  // out = O / l, through the warp's own 16 rows of the q tile (read into
  // registers at chunk 0 by this warp alone), then 16 bytes a store.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* os = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 16 * DN / 32; ++j) {
    const int i = lane + 32 * j, r = i / DN, cc = i % DN;
    const int row = r0 + warp * 16 + r;
    if (row < Tn)
      *reinterpret_cast<uint4*>(out + ((size_t)b * Tn + row) * q_ld +
                                (size_t)h * D + cc * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + cc * 8);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v,
               const float* slopes, void* out, int B, int Tn, int H, int KV,
               float scale, cudaStream_t stream) {
  constexpr int bytes = Tile<D>::SMEM;
  static int raised = 0;
  cudaError_t err = allow_smem(prefill_mma_kernel<D>, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (Tn + BT - 1) / BT);
  prefill_mma_kernel<D><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), slopes, static_cast<bf16*>(out), Tn, H,
      KV, scale);
  return (int)cudaGetLastError();
}

// ---- f32: the CUDA-core route ------------------------------------------

constexpr int THREADS = 256;
constexpr int KP = BS + 4;  // padded row length of the transposed K tile
constexpr int PP = BT + 4;  // padded row length of the transposed p tile

// One block per (64-row T block, q head, batch row) keeps its q tile in
// shared memory and streams 64-row K/V chunks up to its causal limit; each
// thread computes a 4x4 tile of logits and a 4x(D/16) tile of p @ V.
__global__ void __launch_bounds__(THREADS) prefill_f32_kernel(
    const float* q, const float* k, const float* v, const float* slopes,
    float* out, int Tn, int H, int KV, int D, float scale) {
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
    qt[d * BT + r] = row < Tn ? q[(((size_t)b * Tn + row) * H + h) * D + d]
                              : 0.0f;
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
        kv = k[kv0 + (size_t)col * D + d];
        vv = v[kv0 + (size_t)col * D + d];
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
        ps[(part * 16 + i) * PP + r] = e;
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
    float* o = out + (((size_t)b * Tn + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = jj * 64 + tx * 4 + j;
        if (d < D) o[d] = acc[i][jj * 4 + j] / l;
      }
  }
}

int f32_smem_bytes(int D) {
  return 4 * (D * BT + D * KP + BS * D + BT * KP + BS * PP + 3 * BT);
}

int launch_f32(const void* q, const void* k, const void* v,
               const float* slopes, void* out, int B, int Tn, int H, int KV,
               int D, float scale, cudaStream_t stream) {
  // The limit is raised once, for the largest D, so every D launches.
  static int raised = 0;
  cudaError_t err =
      allow_smem(prefill_f32_kernel, f32_smem_bytes(128), &raised);
  if (err != cudaSuccess) return (int)err;
  const int bytes = f32_smem_bytes(D);
  dim3 grid((Tn + BT - 1) / BT, H, B);
  prefill_f32_kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), slopes, static_cast<float*>(out), Tn, H,
      KV, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, H, D), k/v (B, KV, T, D), out (B, T, H, D); slopes (H,) f32 or
// null. bf16 (is_bf16; the tensor-core route): D % 16 == 0, D <= 128, every
// pointer 16-byte aligned. f32 (the CUDA-core route): D % 4 == 0, D <= 128.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* slopes, void* out, int B, int T,
                             int H, int KV, int D, float scale, int is_bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  if (!is_bf16) {
    if (D % 4 != 0 || D > 128) return (int)cudaErrorInvalidValue;
    return launch_f32(q, k, v, sl, out, B, T, H, KV, D, scale, s);
  }
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, sl, out, B, T, H, KV, scale, s);
    case 32: return launch_mma<32>(q, k, v, sl, out, B, T, H, KV, scale, s);
    case 48: return launch_mma<48>(q, k, v, sl, out, B, T, H, KV, scale, s);
    case 64: return launch_mma<64>(q, k, v, sl, out, B, T, H, KV, scale, s);
    case 80: return launch_mma<80>(q, k, v, sl, out, B, T, H, KV, scale, s);
    case 96: return launch_mma<96>(q, k, v, sl, out, B, T, H, KV, scale, s);
    case 112: return launch_mma<112>(q, k, v, sl, out, B, T, H, KV, scale, s);
    case 128: return launch_mma<128>(q, k, v, sl, out, B, T, H, KV, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
