// Kernel K4 of the port: causal flash attention for prefill.
//
// Replaces: sleekit_tpu/ops/attention.py  flash_prefill_pallas /
// _prefill_kernel.
//
// q (B, T, H, D), k/v (B, KV, T, D) in bf16 or f32; out (B, T, H, D) =
// softmax(q k^T * scale [+ slope_h * (col - row)], col <= row) v, where
// q head h reads KV head h / (H / KV) in place (no GQA repeat). Logits,
// the running maxima and the running sums are f32; the sums take p
// unrounded, over 64-row key chunks (BS, = _PREFILL_CHUNK of
// ops/attention.py, so the plain version rounds p against the same running
// maxima), each chunk O = O * alpha + p @ V and O / l at the end. In bf16, p
// is rounded to bf16 before p @ V; in f32 it is not.
//
// What bounds it on an H100: OPT-1.3B's 256-bucket group (B 4, T 256, H
// 32, D 64) moves 16.8 MB in bf16 (5.0 us at 3.35 TB/s), 33.6 MB in f32
// (10.0 us), for 1.08 GFLOP of causal products (1.1 us at 989 TFLOP/s
// bf16; 16.1 us at 67 TFLOP/s on the CUDA cores in f32, 7.6 us as split
// TF32 on the tensor cores at 495 TFLOP/s: 3 products for q k^T, 4 for
// p V); llama3-8b at T 1024 (D 128, 8 KV heads) 21 MB for 8.6 GFLOP, where
// the operations bound. Products on the CUDA cores, through shared memory,
// run at a small share of the tensor cores' rate, so both routes keep both
// products on the tensor cores and every intermediate in registers.
//
// The bf16 design (prefill_mma_kernel<D>, D % 16 == 0, D <= 128): one block
// of 4 warps per (64-row q tile, q head, batch row), 16 q rows a warp, the
// heaviest causal tiles launched first (the tile index runs backwards on
// the slowest grid axis) so the one-chunk tiles fill the tail. q is loaded
// once into m16k16 A fragments (ldmatrix). 64-row K and V chunks stream
// through a two-stage cp.async ring (chunk c + 1 loads while chunk c
// computes), up to the tile's causal limit only, rows at or past T
// zero-filled. S = q k^T is mma.sync m16n8k16 with f32 accumulation, K's
// rows the .col B operand (ldmatrix without .trans); scale, ALiBi and (on
// the diagonal chunk alone) the mask are applied in registers; each row's
// max and sum live in the quad that holds it (__shfl_xor_sync 1, 2 for the
// max, the sum reduced once at the end). p, rounded to bf16, is P @ V's A
// operand straight from the registers (the C layout of two adjacent n8
// tiles is the m16k16 A layout), V's B fragments by ldmatrix.trans. The
// output is divided by the row sum and staged through the warp's own q
// rows of shared memory, so it leaves in 16-byte stores.
//
// The f32 design (prefill_tf32_kernel<DP>, D % 4 == 0, D <= 128, DP = D
// rounded up to 16; the padded columns are zero and never stored): the
// same grid, warps, ring and register softmax, with both products as
// mma.sync m16n8k8 TF32 on split operands, since one TF32 product (10
// mantissa bits) misses the 1e-5 tolerance. q, K and p split as hi =
// cvt.rna.tf32(v), the nearest TF32, plus lo = cvt.rna.tf32(v - hi): v -
// hi is centred on 0, so the dropped q_lo k_lo (at most 2^-22 of a
// product) takes no sign from a mean of q and k. q k^T: q_lo k_hi, q_hi
// k_lo, then q_hi k_hi each k8 step. p V: p in two parts and V in three
// exact ones (hi = v's top 19 bits, mid = those of v - hi, lo = the rest,
// at most 2 bits), p_lo v_hi, p_hi v_lo, p_hi v_mid, p_hi v_hi: where p =
// 1 (row 0) every partial sum is a prefix of v's bits, so the output row
// is V's row bit for bit, which a two-part V misses by up to an f32 step.
// The tensor cores truncate their sums (tests/test_torch_cuda.py
// test_tf32_mma_truncates): an mma cuts each product 25 bits below the
// largest of it and the accumulator. So no chain is long or sums at a
// larger scale than its terms: q k^T is a fresh fragment every QK_CHAIN =
// 2 k8 steps (6 sums), added to S by __fadd_rn (one chain of 3 * DP / 8
// sums into S, 48 at D 128, cuts every product at S's scale and drifts:
// with q and k of mean 1 at D 128 it missed the elementwise gate by 1.6x
// on the card); p V is a fresh fragment each chunk and d tile (32 sums),
// folded in on the CUDA cores as O * alpha + pv, the reference's order.
// The numpy model of this arithmetic (tests/test_torch_prefill_f32.py)
// reads 0.05-0.09 of the elementwise gate from the plain version at D
// 64-128, and 0.10-0.18 from the exact answer with q and k of mean 1 at T
// 1024, where f32 logits rounded once read 0.07-0.19; one q k^T chain a
// chunk reads 0.65 there at D 128, one p V chain straight into O over T
// 1024 0.14 against 0.014.
// Each operand is split in registers as its fragment loads (4 ALU
// operations a V value, 3 a K value, each warp splitting the K and V it
// reads), not once a chunk into shared planes: planes of K's lo and V's
// mid and lo would take 3 more (64, DP + 4) tiles (past 227 KB at DP 128;
// one block an SM at DP 64, where the ring allows two) and a barrier a
// chunk. q and K come by ldmatrix (an 8 x 8 b16 matrix is 8 rows of 4
// f32, the TF32 fragment layout); q is re-read from shared memory and
// split each chunk, so no q register stays live across chunks. P comes
// straight from the S registers, split where P V reads it: in k8 step j,
// k index t is key 8j + 2t and t + 4 is key 8j + 2t + 1, so S's C
// elements (c0, c2, c1, c3) are P's A fragment, and V's B fragment is
// V[2t][g], V[2t + 1][g]. Rows are padded to LD = DP + 4 floats (4 or 20
// mod 32): K's ldmatrix rows and V's words (bank 8t + g) fall on 32
// distinct banks. The tensor-core chains are interleaved (SP tile pairs of
// S, NG d tiles of P V a pass), as many as the registers allow without a
// spill: O takes DP / 2 registers a thread, S and p 32. Scale, ALiBi and
// the mask are rounded as the plain version rounds them (no contraction),
// p = expf(x - m); no atomics, so a launch's bits depend on its inputs
// alone. What bounds it as built, by count (no stall trace runs on the
// card's machine): the instructions a warp executes, about 5 for each mma
// (the splits, the loads, the softmax, S's adds) with 8 warps an SM to
// hide their latency (DP 64: 87,040 bytes of shared memory a block, two
// blocks an SM), rather than the tensor cores' rate or the bytes
// (PERF.md).
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

// ---- f32: split TF32 on the tensor cores ------------------------------

// The shared tiles of padded head dim DP (floats): q, then the ST stages
// of K and V. LD = DP + 4 is 4 or 20 mod 32, so K's B fragments (ldmatrix
// rows LD * 4 bytes apart: an odd number of 16-byte groups) and V's (lane
// (g, t) at word 2t * LD + g, bank 8t + g) each hit 32 distinct banks.
template <int DP>
struct TileF32 {
  static constexpr int LD = DP + 4;
  static_assert(DP % 16 == 0 && (LD % 32 == 4 || LD % 32 == 20),
                "conflict-free rows");
  static constexpr int SMEM = (BT + 2 * ST * BS) * LD * 4;
};

// Rows row0 .. row0 + 63 of a (rows, D) f32 matrix whose rows lie
// ``stride`` floats apart into a tile padded to DP columns, asynchronously;
// rows at or past Tn and columns at or past D are zeros.
template <int DP>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* src,
                                              size_t stride, int row0,
                                              int Tn, int D, int tid) {
  constexpr int CP = DP / 4;  // 16-byte pieces a padded row
#pragma unroll
  for (int j = 0; j < BS * CP / MMA_THREADS; ++j) {
    const int i = tid + j * MMA_THREADS, r = i / CP, c = i % CP;
    const bool ok = row0 + r < Tn && c * 4 < D;
    cp16(dst + r * TileF32<DP>::LD + c * 4,
         ok ? src + (size_t)(row0 + r) * stride + c * 4 : src, ok);
  }
}

// k8 steps of q k^T that one tensor-core fragment sums (3 products a
// step) before S adds it with rounding to nearest.
constexpr int QK_CHAIN = 2;

// The thread's index, read anew where it is called: the chunk loop's
// copies then compute their addresses there, rather than hold 64-bit
// addresses of every piece in registers across the loop (which spilled).
__device__ __forceinline__ int tid_now() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// v = hi + lo in TF32: hi = cvt.rna.tf32(v), the nearest, so v - hi
// (exact) is centred on 0 and at most 2^-11 of v; lo = cvt.rna.tf32(v -
// hi), within 2^-24 of v.
__device__ __forceinline__ void split2(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// The top 19 bits of an f32 value, the TF32 the tensor cores read of it.
constexpr uint32_t TF32_MASK = 0xffffe000u;

// v = hi + mid + lo exactly: hi is v's TF32 prefix, mid that of r = v - hi
// (exact, at most 13 bits), lo = r - mid (exact, at most 2 bits: exact in
// TF32).
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = __float_as_uint(v) & TF32_MASK;
  const float r = __fsub_rn(v, __uint_as_float(hi));
  mid = __float_as_uint(r) & TF32_MASK;
  lo = __float_as_uint(__fsub_rn(r, __uint_as_float(mid)));
}

// Four 8 x 4 f32 matrices by ldmatrix (an 8 x 8 b16 matrix is 8 rows of 4
// f32): lane (g, t) receives float t of row g of each, which is the
// m16n8k8 TF32 fragment layout.
__device__ __forceinline__ void ldsm_f32(uint32_t (&a)[4], const float* p) {
  ldsm_x4(a, reinterpret_cast<const bf16*>(p));
}

// __maxnreg__(255), not __launch_bounds__(MMA_THREADS): under the latter
// ptxas held DP 80-128 to 168 registers and spilled. From DP 64 up the
// shared tiles allow at most two blocks an SM, which 255 registers keep.
template <int DP>
__global__ void __maxnreg__(255) prefill_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ slopes,
    float* __restrict__ out, int Tn, int H, int KV, int D, float scale) {
  constexpr int LD = TileF32<DP>::LD, DK = DP / 8;
  // Work in flight, within 255 registers a thread and no spill at any DP
  // (ptxas -v): SP n8 tile pairs of S a pass, NG d tiles of P V a pass;
  // above DP 64 S's k8 loop is not unrolled.
  constexpr int SP = DP > 64 ? 2 : 4;
  constexpr int NG = DP > 96 ? 1 : DP > 64 ? 2 : 4;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (BT, LD) q, then the output
  float* ks = qs + BT * LD;                      // ST x (BS, LD)
  float* vs = ks + ST * BS * LD;                 // ST x (BS, LD)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tb = gridDim.z - 1 - blockIdx.z;  // heaviest tiles first
  const int r0 = tb * BT, n_chunks = tb + 1;  // chunks up to the causal limit
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t q_ld = (size_t)H * D;
  const float* qb = q + (size_t)b * Tn * q_ld + (size_t)h * D;
  const size_t kv0 = ((size_t)b * KV + h / (H / KV)) * Tn * D;
  const float* kb = k + kv0;
  const float* vb = v + kv0;
  const float slope = slopes ? slopes[h] : 0.0f;

  // One commit group a chunk (q rides with chunk 0); a group past the
  // causal limit is empty.
  copy_rows_f32<DP>(qs, qb, q_ld, r0, Tn, D, tid);
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < n_chunks) {
      copy_rows_f32<DP>(ks + c * BS * LD, kb, D, c * BS, Tn, D, tid);
      copy_rows_f32<DP>(vs + c * BS * LD, vb, D, c * BS, Tn, D, tid);
    }
    cp_commit();
  }

  float o[DK][4];
#pragma unroll
  for (int n = 0; n < DK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  // This thread's two rows, g and g + 8 of the warp's 16: running max and
  // the sum of its own columns (the quad's sum is taken at the end).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int row0 = r0 + warp * 16 + g;
  // ldmatrix row addresses: q's A fragment (matrix i: rows 8 * (i % 2),
  // columns 4 * (i / 2)) and K's B fragments of two n8 tiles (matrix i:
  // keys 8 * (i / 2), columns 4 * (i % 2)).
  const int mi = lane / 8, ri = lane % 8;
  const float* qa = qs + (warp * 16 + 8 * (mi % 2) + ri) * LD + 4 * (mi / 2);
  const int ka = (8 * (mi / 2) + ri) * LD + 4 * (mi % 2);

  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<ST - 2>();  // chunk c (and q) landed; later ones may be in flight
    __syncthreads();    // ... for every thread, and chunk c - 1 is consumed
    {  // chunk c + ST - 1 into the stage chunk c - 1 used
      const int cn = c + ST - 1, sn = cn % ST;
      if (cn < n_chunks) {
        const int tn = tid_now();
        copy_rows_f32<DP>(ks + sn * BS * LD, kb, D, cn * BS, Tn, D, tn);
        copy_rows_f32<DP>(vs + sn * BS * LD, vb, D, cn * BS, Tn, D, tn);
      }
      cp_commit();
    }
    const float* kt = ks + (c % ST) * BS * LD;
    const float* vc = vs + (c % ST) * BS * LD;

    // S = q k^T: 16 rows x 64 keys a warp, eight n8 tiles. Each k8 step
    // q_lo k_hi, q_hi k_lo, then q_hi k_hi, into a fresh fragment every
    // QK_CHAIN k8 steps that is added to S by __fadd_rn; each product over
    // a pass's 2 * SP tiles in turn (that many chains in flight).
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll (DP > 64 ? 1 : DK / QK_CHAIN)
    for (int k0 = 0; k0 < DK; k0 += QK_CHAIN) {
      // SP pairs of n8 tiles a pass, from pair p0; the pass's tile n has
      // the B fragment kh[n][0 .. 1], kl[n][0 .. 1] and the fragment f[n].
      // q's A fragment is read and split in each pass (one pass up to DP
      // 64).
#pragma unroll
      for (int p0 = 0; p0 < 4; p0 += SP) {
        float f[2 * SP][4];
#pragma unroll
        for (int n = 0; n < 2 * SP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[n][e] = 0.0f;
#pragma unroll
        for (int j = 0; j < QK_CHAIN; ++j) {
          uint32_t qr[4], qh[4], ql[4];
          ldsm_f32(qr, qa + (k0 + j) * 8);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split2(__uint_as_float(qr[e]), qh[e], ql[e]);
          uint32_t kh[2 * SP][2], kl[2 * SP][2];
#pragma unroll
          for (int np = 0; np < SP; ++np) {
            uint32_t kr[4];
            ldsm_f32(kr, kt + (p0 + np) * 16 * LD + ka + (k0 + j) * 8);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split2(__uint_as_float(kr[e]), kh[2 * np + e / 2][e % 2],
                     kl[2 * np + e / 2][e % 2]);
          }
#pragma unroll
          for (int n = 0; n < 2 * SP; ++n)
            mma_tf32(f[n], ql, kh[n][0], kh[n][1]);
#pragma unroll
          for (int n = 0; n < 2 * SP; ++n)
            mma_tf32(f[n], qh, kl[n][0], kl[n][1]);
#pragma unroll
          for (int n = 0; n < 2 * SP; ++n)
            mma_tf32(f[n], qh, kh[n][0], kh[n][1]);
        }
#pragma unroll
        for (int n = 0; n < 2 * SP; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[2 * p0 + n][e] = __fadd_rn(s[2 * p0 + n][e], f[n][e]);
      }
    }

    // Logits in registers: element e of tile n is row row0 + 8 * (e / 2),
    // column c0 + 8n + 2t + e % 2; each product and sum rounded as the
    // plain version rounds it. Only the diagonal (last) chunk holds a
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
        float x = __fmul_rn(s[n][e], scale);
        if (slopes) x = __fadd_rn(x, __fmul_rn(slope, (float)(col - row)));
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
      alpha[i] = expf(__fsub_rn(m[i], mx[i]));
      m[i] = mx[i];
      l[i] = __fmul_rn(l[i], alpha[i]);
    }
    // p, unrounded into the sums; P's A fragments come from these registers
    // (split into two TF32 parts where P V reads them). Key order of k8
    // step j: k index t is key 8j + 2t, t + 4 is 8j + 2t + 1, so the C
    // elements (c0, c2, c1, c3) of tile j are (a0 .. a3).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(__fsub_rn(s[j][e], m[e / 2]));
        l[e / 2] = __fadd_rn(l[e / 2], s[j][e]);
      }

    // O = O * alpha + P V, P V a fresh fragment a d tile (the tensor cores
    // truncate their sums: a chain stays inside the chunk), NG d tiles at
    // a time (NG chains in flight). V in three exact TF32 parts, P in two,
    // smallest products first: p_lo v_hi, p_hi v_lo, p_hi v_mid, p_hi v_hi.
#pragma unroll
    for (int n0 = 0; n0 < DK; n0 += NG) {
      float pv[NG][4];
#pragma unroll
      for (int u = 0; u < NG; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[u][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split2(s[j][(e % 2) * 2 + e / 2], ph[e], pl[e]);
        uint32_t vh[NG][2], vm[NG][2], vl[NG][2];
#pragma unroll
        for (int u = 0; u < NG; ++u)
          if (n0 + u < DK) {
            const float* vr = vc + (8 * j + 2 * t) * LD + 8 * (n0 + u) + g;
            split3(vr[0], vh[u][0], vm[u][0], vl[u][0]);
            split3(vr[LD], vh[u][1], vm[u][1], vl[u][1]);
          }
#pragma unroll
        for (int u = 0; u < NG; ++u)
          if (n0 + u < DK) mma_tf32(pv[u], pl, vh[u][0], vh[u][1]);
#pragma unroll
        for (int u = 0; u < NG; ++u)
          if (n0 + u < DK) mma_tf32(pv[u], ph, vl[u][0], vl[u][1]);
#pragma unroll
        for (int u = 0; u < NG; ++u)
          if (n0 + u < DK) mma_tf32(pv[u], ph, vm[u][0], vm[u][1]);
#pragma unroll
        for (int u = 0; u < NG; ++u)
          if (n0 + u < DK) mma_tf32(pv[u], ph, vh[u][0], vh[u][1]);
      }
#pragma unroll
      for (int u = 0; u < NG; ++u)
        if (n0 + u < DK)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n0 + u][e] =
                __fadd_rn(__fmul_rn(o[n0 + u][e], alpha[e / 2]), pv[u][e]);
    }
  }

  // out = O / l, through the warp's own 16 rows of the q tile (read only by
  // this warp), then 16 bytes a store; columns past D are not stored.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncwarp();
  float* os = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < DK; ++n) {
    *reinterpret_cast<float2*>(os + g * LD + n * 8 + 2 * t) =
        make_float2(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<float2*>(os + (g + 8) * LD + n * 8 + 2 * t) =
        make_float2(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
  constexpr int CP = DP / 4;
#pragma unroll
  for (int j = 0; j < 16 * CP / 32; ++j) {
    const int i = lane + 32 * j, r = i / CP, cc = i % CP;
    const int row = r0 + warp * 16 + r;
    if (row < Tn && cc * 4 < D)
      *reinterpret_cast<float4*>(out + ((size_t)b * Tn + row) * q_ld +
                                 (size_t)h * D + cc * 4) =
          *reinterpret_cast<const float4*>(os + r * LD + cc * 4);
  }
}

template <int DP>
int launch_tf32(const void* q, const void* k, const void* v,
                const float* slopes, void* out, int B, int Tn, int H, int KV,
                int D, float scale, cudaStream_t stream) {
  constexpr int bytes = TileF32<DP>::SMEM;
  static int raised = 0;
  cudaError_t err = allow_smem(prefill_tf32_kernel<DP>, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B, (Tn + BT - 1) / BT);
  prefill_tf32_kernel<DP><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), slopes, static_cast<float*>(out), Tn, H,
      KV, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, T, H, D), k/v (B, KV, T, D), out (B, T, H, D); slopes (H,) f32 or
// null. bf16 (is_bf16): D % 16 == 0, D <= 128. f32: D % 4 == 0, D <= 128.
// Both on the tensor cores; every pointer 16-byte aligned.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             const void* slopes, void* out, int B, int T,
                             int H, int KV, int D, float scale, int is_bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sl = static_cast<const float*>(slopes);
  if (!is_bf16) {
    if (D % 4 != 0 || D > 128 || D <= 0) return (int)cudaErrorInvalidValue;
    switch ((D + 15) / 16 * 16) {
      case 16: return launch_tf32<16>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
      case 32: return launch_tf32<32>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
      case 48: return launch_tf32<48>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
      case 64: return launch_tf32<64>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
      case 80: return launch_tf32<80>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
      case 96: return launch_tf32<96>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
      case 112: return launch_tf32<112>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
      default: return launch_tf32<128>(q, k, v, sl, out, B, T, H, KV, D, scale, s);
    }
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
