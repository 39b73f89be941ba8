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
// K11 with the batch folded into each block. All six are modes of one body,
// decode_kernel: MODE (FUSED_APPEND, FLASH, FLASH_EW, FLASH_BFOLD) and
// PAGED are template flags.
//
// What bounds it on an H100: the cache rows it must read, (pos+1) * (2D + 4)
// bytes of int8 K and V and their two bf16 scales per (batch row, KV head) -
// at OPT-1.3B batch 8, pos 256 about 8.8 MB per layer, 2.6 us at 3.35 TB/s.
// That is few bytes per block and little arithmetic, so in practice a
// launch is bound by each block's chain of dependent steps (pos, rows,
// reductions, the combine) and by the instructions it issues; the design
// keeps both short and runs the grid in about one wave.
//
// What the design does about it:
// - Split over the cache rows. Block (h, b, c) reads logical rows
//   [c*R, c*R + R) of (b, h), s < pos fused, s <= pos otherwise; R (a
//   multiple of 16: 256 rows of int8 D = 64, as many as 16 KB of K rows
//   hold) depends on D and the cache dtype alone (ops/attention.py
//   decode_plan), so a split's arithmetic depends only on its logical
//   rows: K5's output and written bytes equal K3's, K13's output equals
//   K11's, bit for bit. The grid covers the capacity (S, or MAXP*PS) with
//   the split index slowest, so a row's splits past its last row exit at
//   once and come last; pos stays on the device, so a captured graph
//   replays at any position.
// - Coalesced 16-byte row loads, all in flight at once. A warp reads whole
//   rows as 16-byte chunks (int8 D = 64: 4 lanes a row, 8 rows a warp
//   instruction); each lane cp.asyncs the chunks of all its rows into
//   shared memory (K, then V) and reads back exactly those, so only its
//   own wait orders them and no register holds a load in flight. The
//   split's scales are one coalesced load of its rows'. q is staged in
//   shared memory; a lane keeps its 16-byte slice of it for the GT query
//   heads of a pass (all G of the KV head, up to 4) in registers, so one
//   loaded row serves them all. q.k sums over a row's lanes by shuffles
//   (int8 widened exactly by a byte permute and one add: I2F runs at a
//   quarter of the FMA rate); p.v accumulates each lane's columns over its
//   rows, then reduces over the warp's rows by a reduce-scatter of
//   shuffles and over the warps through shared memory, in a fixed order.
//   The main path's types at D = 64 take the body with the head dim known
//   at compile time (every lane index folds to a constant).
// - Softmax within a split against the split's own max (p rounded to the
//   compute dtype there, as the TPU kernel rounds p against its running
//   max; not in K12). Each split writes (acc[G, D], m, l) in f32 to the
//   scratch (B, KV, splits, G, D + 2); the last split of (b, h) to finish -
//   an int ticket per (b, h), taken by an acquire-release atomic after a
//   barrier and reset to 0 by the block that takes the last one - combines
//   the splits in ascending order (no float atomics: two calls give the
//   same bits). A row with one live split combines in the block, without
//   scratch or ticket.
// - The new token (K3, K5): the combining block quantizes it, adds its logit
//   and value in the combine and writes row pos and its scales. No split
//   reads row pos, so the write races nothing.
// - K13: one block per (KV head, split) whose groups of 128 threads walk
//   the batch rows, each syncing on its own named barrier, with K11's
//   arithmetic per (b, split) and K11's combine.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // threads of one (split, KV head, batch row)
constexpr int NWARPS = THREADS / 32;
constexpr int MIN_ROWS = 16;  // rows of a split (decode_plan), at least
constexpr int MAX_ROWS = 256;
constexpr int SMEM_BYTES = 227 * 1024;  // a block's shared memory, at most
constexpr int MIN_THREADS = 1024;  // one query head a pass: threads an SM

// The schedules of the flash-decode body.
enum Mode { FUSED_APPEND, FLASH, FLASH_EW, FLASH_BFOLD };

// Query heads served per pass over the rows at G > 1: all of a KV head's,
// up to 4.
constexpr int GQA_HEADS = 4;

// K13: groups of THREADS per block (batch rows decoded at once).
__host__ __device__ constexpr int fold_groups(int GT) {
  return (GT == 1 ? 1024 : 256) / THREADS;
}

// Blocks an SM must hold (ptxas keeps the registers to that): one query
// head a pass is latency-bound, and more blocks in flight hide it.
__host__ __device__ constexpr int min_blocks(int MODE, int GT) {
  return MODE == FLASH_BFOLD || GT > 1 ? 1 : MIN_THREADS / THREADS;
}

// Lanes that read one row of D elements, 16 bytes each (a power of two, at
// most 32; a lane reads two 16-byte chunks of an f32 row above D = 128).
__host__ __device__ constexpr int lanes_per_row(int D, int csize) {
  const int chunks = (D * csize + 15) / 16;
  int l = 1;
  while (l < chunks && l < 32) l <<= 1;
  return l;
}

// Where the cache keeps logical row s of (layer, batch row b, KV head h),
// in rows of D elements (or in elements of a scale plane).
struct Rows {
  const int* table;  // (B, MAXP) int32, or null for a slot cache
  int layer, P, KV, PS, MAXP;
  int ps_shift;      // log2(PS) where PS is a power of two, else -1

  __device__ __forceinline__ size_t at(int b, int h, int s) const {
    const int j = ps_shift >= 0 ? s >> ps_shift : s / PS;
    const int r = ps_shift >= 0 ? s & (PS - 1) : s % PS;
    const int page = table ? __ldg(table + b * MAXP + j) : b;
    return (((size_t)layer * P + page) * KV + h) * PS + r;
  }
};

// The split plan (ops/attention.py decode_plan) and its scratch.
struct Plan {
  float* part;   // (B, KV, splits, G, D + 2) f32: acc[D], m, l
  int* tickets;  // (B, KV) int32, 0 between launches
  int R, splits;
};

// Floats of shared memory one group uses: logits (GT, R), the split's key
// and value scales (2, R), the warps' p @ V (NWARPS, GT, D), the warps'
// maxima and sums (2, NWARPS, GT), the token's logits (GT), the new
// token's K and V and their scales (2D + 2), the ticket's verdict (1), q
// (G, D); fused, the raw token's K and V (2D).
__host__ __device__ inline int group_floats(int GT, int R, int D, int G,
                                            bool fused) {
  return GT * R + 2 * R + NWARPS * GT * D + (2 * NWARPS + 1) * GT + 2 * D +
         3 + G * D + (fused ? 2 * D : 0);
}

// Bytes of shared memory a cache row takes: whole 16-byte chunks.
__host__ __device__ inline int row_bytes(int D, int csize) {
  return (D * csize + 15) / 16 * 16;
}

// Bytes of shared memory one group uses: the split's K and V rows, then
// group_floats.
__host__ __device__ inline int group_bytes(int GT, int R, int D, int G,
                                           bool fused, int csize) {
  return (2 * R * row_bytes(D, csize) +
          4 * group_floats(GT, R, D, G, fused) + 15) / 16 * 16;
}

// A row's 16-byte chunk at element d0 into shared memory, asynchronously
// (cp.async, zeros where !ok); element by element, at once, where the rows
// are not 16-byte aligned (zeros past D).
template <typename CT>
__device__ __forceinline__ void fetch_chunk(void* dst, const CT* row, int d0,
                                            int D, bool vec, bool ok) {
  if (vec) {
    cp16(dst, row + (ok ? d0 : 0), ok);
    return;
  }
  constexpr int VEC = 16 / sizeof(CT);
  CT* e = static_cast<CT*>(dst);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    e[k] = ok && d0 + k < D ? row[d0 + k] : CT{};
}

// The elements of a chunk as f32, exactly. An int8 b becomes the float
// 2^23 + (b + 128) by one byte permute, then b by one add: I2F runs at a
// quarter of the FMA rate on Hopper, and a chunk holds 16 of them.
template <typename CT>
__device__ __forceinline__ void unpack(const uint4& v,
                                       float (&f)[16 / sizeof(CT)]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (std::is_same<CT, int8_t>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[4 * i + k] =
            __int_as_float(__byte_perm(u, 0x4b000000u, 0x7440 | k)) -
            8388736.0f;
    }
  } else if constexpr (std::is_same<CT, bf16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __int_as_float(w[i] << 16);
      f[2 * i + 1] = __int_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __int_as_float(w[i]);
  }
}

// One ticket of a (b, h): an atomic add with release and acquire
// semantics at the device's scope; returns the tickets taken before.
__device__ __forceinline__ int take_ticket(int* t) {
  int before;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(before) : "l"(t) : "memory");
  return before;
}

// Grid (KV, B, splits), or (K13, FLASH_BFOLD) (KV, 1, splits) with groups
// of THREADS threads walking the batch rows j, j + groups, ... of their
// block; a row's splits past its last row exit at once, and come last.
// PAGED: rows.table is set (K5, K15); else the slot rule. GT: query heads
// per pass over the rows (G is walked in passes of GT). DT: the head dim
// at compile time (the main path's 64; its lane layout and every index
// then fold to constants), or 0: the head dim Darg at run time.
template <typename QT, typename CT, typename ST, bool QUANT, int MODE,
          bool PAGED, int GT, int DT>
__global__ void __launch_bounds__(MODE == FLASH_BFOLD
                                      ? fold_groups(GT) * THREADS
                                      : THREADS,
                                  min_blocks(MODE, GT))
    decode_kernel(const QT* q, const QT* k_new, const QT* v_new,
                  CT* cache_k, CT* cache_v, ST* k_scale, ST* v_scale,
                  const float* slopes, const int* pos_ptr, QT* out,
                  Rows rows, Plan plan, int pos_scalar, int B, int G,
                  int Darg, float scale) {
  const int D = DT ? DT : Darg;
  constexpr bool FUSED = MODE == FUSED_APPEND;
  constexpr bool EW = MODE == FLASH_EW;
  constexpr bool FOLD = MODE == FLASH_BFOLD;
  // bf16 compute: q, K, V and p rounded to bf16 (never in K12).
  constexpr bool BF = std::is_same<QT, bf16>::value && !EW;
  constexpr int VEC = 16 / sizeof(CT);       // elements of a 16-byte load
  constexpr int NCH = sizeof(CT) == 4 ? 2 : 1;  // chunks a lane, at most
  const int R = plan.R, splits = plan.splits;
  const int j = FOLD ? threadIdx.x / THREADS : 0;  // this thread's group
  const int tid = FOLD ? threadIdx.x % THREADS : threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  extern __shared__ float4 smem4[];
  const int rby = row_bytes(D, sizeof(CT));
  unsigned char* kbuf = reinterpret_cast<unsigned char*>(smem4) +
                        j * group_bytes(GT, R, D, G, FUSED, sizeof(CT));
  unsigned char* vbuf = kbuf + R * rby;  // (R, rby) the split's K, V rows
  float* lg = reinterpret_cast<float*>(vbuf + R * rby);  // (GT, R) logits
  float* sks = lg + GT * R;            // (R) key scales of the split
  float* svs = sks + R;                // (R) value scales
  float* red = svs + R;                // (NWARPS, GT, D) the warps' p @ V
  float* wm = red + NWARPS * GT * D;   // (NWARPS, GT) the warps' maxima
  float* wl = wm + NWARPS * GT;        // (NWARPS, GT) the warps' sums of e
  float* st = wl + NWARPS * GT;        // (GT) the token's logits
  float* tok = st + GT;                // (2, D) token K, V; their 2 scales
  int* verdict = reinterpret_cast<int*>(tok + 2 * D + 2);
  float* qs = tok + 2 * D + 3;         // (G, D) q
  float* raw = qs + G * D;             // fused: (2, D) k_new, v_new
  auto sync = [j] {
    if constexpr (FOLD)
      asm volatile("bar.sync %0, %1;" ::"r"(1 + j), "r"(THREADS) : "memory");
    else
      __syncthreads();
  };

  // The lanes of a row, the rows of a warp step and of a block step.
  const int lpr = lanes_per_row(D, sizeof(CT));
  const int rpw = 32 / lpr, rb = NWARPS * rpw, ns = R / rb;
  const int sub = lane & (lpr - 1), slot = lane >> (__ffs(lpr) - 1);
  const int nch = (D + lpr * VEC - 1) / (lpr * VEC);
  const int c16 = rby / 16;  // chunks of a row
  const bool vec = (D * sizeof(CT)) % 16 == 0 &&
                   ((uintptr_t)cache_k | (uintptr_t)cache_v) % 16 == 0;
  const int h = blockIdx.x, c = blockIdx.z, KV = rows.KV;

  const int groups = FOLD ? blockDim.x / THREADS : 1;
  const int n_rows = FOLD ? (B - j + groups - 1) / groups : 1;
  for (int it = 0; it < n_rows; ++it) {
    const int b = FOLD ? j + it * groups : blockIdx.y;
    int p = pos_ptr ? pos_ptr[b] : pos_scalar;
    p = min(max(p, 0), rows.MAXP * rows.PS - 1);
    // Cached rows read: s < p when the token comes from registers, else
    // s <= p; nsp live splits (one when only the token is left).
    const int n = FUSED ? p : p + 1;
    const int nsp = max(1, (n + R - 1) / R);
    if (c >= nsp) continue;
    if (FOLD && it > 0) sync();  // the last row's reads of smem are done
    const bool direct = nsp == 1;  // combined here: no scratch, no ticket
    const int s0 = c * R, cnt = min(R, n - s0);
    const size_t bh = (size_t)b * KV + h;
    const float* part_in = plan.part + bh * splits * G * (D + 2);
    float* part_out = plan.part + (bh * splits + c) * G * (D + 2);
    // Logical row s of (b, h) in the cache; the slot rule without a table.
    const size_t slot0 = PAGED ? 0 : rows.at(b, h, 0);
    auto addr = [&](int s) { return PAGED ? rows.at(b, h, s) : slot0 + s; };

    // Step u of this lane: row u*rb + warp*rpw + slot of the split. A warp
    // takes the steps that hold a row below cnt, nsw of them.
    auto local = [&](int u) { return u * rb + warp * rpw + slot; };
    const int nsw = min(ns, max(0, (cnt - warp * rpw + rb - 1) / rb));
    // The chunks of its rows that this lane reads, into buf: each lane
    // fetches exactly what it reads back, so only its own cp.async wait
    // orders them. A chunk of this lane, and whether the row has it.
    auto chunk = [&](unsigned char* buf, int u, int ch) {
      return buf + local(u) * rby + (ch * lpr + sub) * 16;
    };
    auto fetch = [&](unsigned char* buf, const CT* cache) {
      for (int u = 0; u < nsw; ++u) {
        const int i = local(u);
        const CT* row = cache + (i < cnt ? addr(s0 + i) : 0) * D;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
          if (ch * lpr + sub < c16)
            fetch_chunk(chunk(buf, u, ch), row, (ch * lpr + sub) * VEC, D,
                        vec, i < cnt);
      }
      cp_commit();
    };
    auto read = [&](unsigned char* buf, int u, int ch) {
      return ch * lpr + sub < c16
                 ? *reinterpret_cast<const uint4*>(chunk(buf, u, ch))
                 : make_uint4(0, 0, 0, 0);
    };

    // The new token in the compute dtype from raw (int8 caches quantize it
    // here) and its scales.
    auto token = [&] {
      if constexpr (QUANT) {
        if (warp < 2) {
          const float* src = raw + warp * D;
          float amax = 0.0f;
          for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(src[d]));
          const float sc = fmaxf(warp_max(amax) / 127.0f, 1e-8f);
          for (int d = lane; d < D; d += 32)
            tok[warp * D + d] =
                fminf(fmaxf(rintf(src[d] / sc), -127.0f), 127.0f);
          // The token's scale round-trips the stored scale dtype first.
          if (lane == 0) tok[2 * D + warp] = to_f(from_f<ST>(sc));
        }
      } else {
        for (int i = tid; i < 2 * D; i += THREADS) {
          const float v = to_f(from_f<CT>(raw[i]));
          tok[i] = BF ? round_bf16(v) : v;
        }
        if (tid == 0) tok[2 * D] = tok[2 * D + 1] = 1.0f;
      }
    };

    // Combine the splits of query heads g0 .. g0+GT-1 in ascending order,
    // then the token (fused), and write out: split c2's m (e = D), l
    // (e = D + 1) and acc (e < D) of head g from get(c2, g, e). Each output
    // element's thread folds the splits in with a running max (the same
    // sequence, so the same bits, in every thread of a head), its loads of
    // them independent of one another.
    auto combine = [&](int g0, auto get) {
      if constexpr (FUSED) {  // the token's logit of each head of the pass
        if (warp < GT && g0 + warp < G) {
          const float* qg = qs + (g0 + warp) * D;
          float s = 0.0f;
          for (int d = lane; d < D; d += 32) s += qg[d] * tok[d];
          float nl = warp_sum(s) * scale;  // ALiBi distance of the token: 0
          if constexpr (QUANT) nl *= tok[2 * D];
          if (lane == 0) st[warp] = nl;
        }
        sync();
      }
      for (int i = tid; i < GT * D; i += THREADS) {
        const int gg = i / D, d = i % D, g = g0 + gg;
        if (g >= G) continue;
        const float nl = FUSED ? st[gg] : -INFINITY;
        float M = nl, L = 0.0f, a = 0.0f;
#pragma unroll 4
        for (int c2 = 0; c2 < nsp; ++c2) {
          const float m = get(c2, g, D), l = get(c2, g, D + 1);
          const float x = get(c2, g, d);
          const float mn = fmaxf(M, m);
          const float keep = M == -INFINITY ? 0.0f : expf(M - mn);
          const float w = m == -INFINITY ? 0.0f : expf(m - mn);
          L = L * keep + w * l;
          a = a * keep + w * x;
          M = mn;
        }
        if constexpr (FUSED) {
          const float e = expf(nl - M);
          const float pt = e * tok[2 * D + 1];
          L += e;
          a += (BF ? round_bf16(pt) : pt) * tok[D + d];
        }
        out[(bh * G + g) * D + d] = from_f<QT>(a / L);
      }
      sync();
    };

    // The split's K and V rows in flight, then its scales (one coalesced
    // load of its rows'), q and (fused) the token, while they arrive.
    fetch(kbuf, cache_k);
    fetch(vbuf, cache_v);
    for (int i = tid; i < R; i += THREADS) {
      float ks = 1.0f, vs = 1.0f;
      if (QUANT && i < cnt) {
        const size_t r = addr(s0 + i);
        ks = to_f(k_scale[r]);
        vs = to_f(v_scale[r]);
      }
      sks[i] = ks;
      svs[i] = vs;
    }
    for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(q[bh * G * D + i]);
    if constexpr (FUSED) {
      for (int i = tid; i < 2 * D; i += THREADS)
        raw[i] = to_f(i < D ? k_new[bh * D + i] : v_new[bh * D + i - D]);
    }
    sync();
    if (FUSED && direct) token();

    for (int g0 = 0; g0 < G; g0 += GT) {
      // This lane's slice of q for each head of the pass, and its slope.
      float qf[GT][NCH][VEC], slope[GT];
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        const int g = g0 + gg;
        const float* qg = qs + min(g, G - 1) * D;
        slope[gg] = slopes && g < G ? slopes[h * G + g] : 0.0f;  // ALiBi
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const int d = (ch * lpr + sub) * VEC + k;
            qf[gg][ch][k] = g < G && ch < nch && d < D ? qg[d] : 0.0f;
          }
      }

      // Logits of the split's rows: a row's lanes each dot their chunk,
      // then sum over the row's lanes; the warps' maxima.
      float mx[GT];
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) mx[gg] = -INFINITY;
      cp_wait<1>();  // this lane's K rows
      for (int u = 0; u < nsw; ++u) {
        {
          const int i = local(u);
          // K12 scales each key element before the dot, the others the
          // logit.
          const float ksc = sks[i];
          float dot[GT];
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) dot[gg] = 0.0f;
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            float e[VEC];
            unpack<CT>(read(kbuf, u, ch), e);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              float kv = e[k];
              if (BF && !QUANT) kv = round_bf16(kv);
              if constexpr (EW && QUANT) kv *= ksc;
#pragma unroll
              for (int gg = 0; gg < GT; ++gg) dot[gg] += qf[gg][ch][k] * kv;
            }
          }
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            float s = dot[gg];
            for (int o = 1; o < lpr; o <<= 1)
              s += __shfl_xor_sync(0xffffffffu, s, o);
            float l = s * scale;
            if constexpr (QUANT && !EW) l *= ksc;
            if (slopes) l += slope[gg] * (float)(s0 + i - p);
            l = i < cnt ? l : -INFINITY;
            mx[gg] = fmaxf(mx[gg], l);
            if (sub == 0) lg[gg * R + i] = l;
          }
        }
      }
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        const float m = warp_max(mx[gg]);
        if (lane == 0) wm[warp * GT + gg] = m;
      }
      sync();

      // p @ V: e against the split's max (the warps' maxima), its sum, and
      // p = e (times the value scale) rounded to the compute dtype; each
      // lane its columns over its rows.
      float m[GT], sum[GT], acc[GT][NCH][VEC];
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        m[gg] = wm[gg];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) m[gg] = fmaxf(m[gg], wm[w * GT + gg]);
        sum[gg] = 0.0f;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[gg][ch][k] = 0.0f;
      }
      cp_wait<0>();  // this lane's V rows
      for (int u = 0; u < nsw; ++u) {
        {
          const int i = local(u);
          float pv[GT];
#pragma unroll
          for (int gg = 0; gg < GT; ++gg) {
            float e = 0.0f;
            if (i < cnt) {
              e = expf(lg[gg * R + i] - m[gg]);
              if (sub == 0) sum[gg] += e;
              if constexpr (QUANT) e *= svs[i];
            }
            pv[gg] = BF ? round_bf16(e) : e;
          }
#pragma unroll
          for (int ch = 0; ch < NCH; ++ch) {
            float e[VEC];
            unpack<CT>(read(vbuf, u, ch), e);
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              float vv = e[k];
              if (BF && !QUANT) vv = round_bf16(vv);
#pragma unroll
              for (int gg = 0; gg < GT; ++gg) acc[gg][ch][k] += pv[gg] * vv;
            }
          }
        }
      }
      // Sum over the warp's rows: a reduce-scatter over the slot bits of
      // the lane (each level keeps half the columns and adds the partner
      // lane's), then, where a warp has more rows than a lane columns, a
      // butterfly; then over the warps, in order, through red.
      constexpr int NV = NCH * VEC;
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        float a[NV];
#pragma unroll
        for (int x = 0; x < NV; ++x) a[x] = acc[gg][x / VEC][x % VEC];
        int base = 0, o = lpr, have = NV;
#pragma unroll
        for (int t = 1; t < NV; t <<= 1) {
          if (o < 32) {
            const int half = NV / (2 * t);
            const bool upper = lane & o;
#pragma unroll
            for (int x = 0; x < half; ++x) {
              const float keep = upper ? a[x + half] : a[x];
              const float send = upper ? a[x] : a[x + half];
              a[x] = keep + __shfl_xor_sync(0xffffffffu, send, o);
            }
            base += upper ? half : 0;
            have = half;
            o <<= 1;
          }
        }
        const bool first = o < 32 ? (lane & (32 - o)) == 0 : true;
        for (; o < 32; o <<= 1) a[0] += __shfl_xor_sync(0xffffffffu, a[0], o);
#pragma unroll
        for (int x = 0; x < NV; ++x) {
          const int ch = (base + x) / VEC;
          const int d = (ch * lpr + sub) * VEC + (base + x) % VEC;
          if (x < have && first && ch < nch && d < D)
            red[(warp * GT + gg) * D + d] = a[x];
        }
        const float l = warp_sum(sum[gg]);
        if (lane == 0) wl[warp * GT + gg] = l;
      }
      sync();

      // The split's acc of head g0 + gg, column d, and its sum of e: the
      // warps in order; its max.
      auto split_acc = [&](int gg, int d) {
        float a = red[gg * D + d];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) a += red[(w * GT + gg) * D + d];
        return a;
      };
      auto split_stat = [&](int gg, int e) {  // e = D: m, D + 1: l
        const float* v = e == D ? wm : wl;
        float a = v[gg];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w)
          a = e == D ? fmaxf(a, v[w * GT + gg]) : a + v[w * GT + gg];
        return a;
      };
      if (direct) {
        combine(g0, [&](int, int g, int e) {
          const int gg = g - g0;
          return e < D ? split_acc(gg, e) : split_stat(gg, e);
        });
      } else {
        for (int i = tid; i < GT * (D + 2); i += THREADS) {
          const int gg = i / (D + 2), e = i % (D + 2), g = g0 + gg;
          if (g < G)
            part_out[g * (D + 2) + e] =
                e < D ? split_acc(gg, e) : split_stat(gg, e);
        }
        sync();
      }
    }

    if (!direct) {
      // The last split of (b, h) to finish combines them all: the block's
      // partials are ordered before its ticket by the barrier and the
      // ticket's release, and the other blocks' before the last ticket's
      // reads by its acquire and the barrier.
      if (tid == 0) *verdict = take_ticket(plan.tickets + bh) == nsp - 1;
      sync();
      if (!*verdict) continue;
      if constexpr (FUSED) {
        token();
        sync();
      }
      for (int g0 = 0; g0 < G; g0 += GT)
        combine(g0, [&](int c2, int g, int e) {
          return __ldcg(part_in + ((size_t)c2 * G + g) * (D + 2) + e);
        });
      if (tid == 0) plan.tickets[bh] = 0;  // ready for the next launch
    }
    if constexpr (FUSED) {
      // Persist the token row (and its scales) at p; no split reads row p.
      const size_t r = addr(p);
      CT* kw = cache_k + r * D;
      CT* vw = cache_v + r * D;
      for (int d = tid; d < D; d += THREADS) {
        if constexpr (QUANT) {
          kw[d] = (int8_t)tok[d];
          vw[d] = (int8_t)tok[D + d];
        } else {
          kw[d] = from_f<CT>(raw[d]);
          vw[d] = from_f<CT>(raw[D + d]);
        }
      }
      if (QUANT && tid == 0) {
        k_scale[r] = from_f<ST>(tok[2 * D]);
        v_scale[r] = from_f<ST>(tok[2 * D + 1]);
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
  Plan plan;
  int pos_scalar, B, G, D;
  float scale;
};

template <typename QT, typename CT, typename ST, bool QUANT, int MODE,
          bool PAGED, int GT, int DT>
int launch_rule(const Launch& a, cudaStream_t stream) {
  // K13: one block per (split, KV head), a group of THREADS per batch row
  // (up to fold_groups rows at once); the others one block per (split, KV
  // head, row).
  const int one = group_bytes(GT, a.plan.R, a.D, a.G, MODE == FUSED_APPEND,
                              sizeof(CT));
  const int groups = MODE == FLASH_BFOLD
                         ? max(1, min(min(a.B, fold_groups(GT)),
                                      SMEM_BYTES / one))
                         : 1;
  const int bytes = groups * one;
  static int raised = 0;
  cudaError_t err = allow_smem(
      decode_kernel<QT, CT, ST, QUANT, MODE, PAGED, GT, DT>, bytes, &raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.rows.KV, MODE == FLASH_BFOLD ? 1 : a.B, a.plan.splits);
  decode_kernel<QT, CT, ST, QUANT, MODE, PAGED, GT, DT>
      <<<grid, groups * THREADS, bytes, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const QT*>(a.k_new),
      static_cast<const QT*>(a.v_new), static_cast<CT*>(a.cache_k),
      static_cast<CT*>(a.cache_v), static_cast<ST*>(a.k_scale),
      static_cast<ST*>(a.v_scale), a.slopes, a.pos, static_cast<QT*>(a.out),
      a.rows, a.plan, a.pos_scalar, a.B, a.G, a.D, a.scale);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT, typename ST, bool QUANT, int MODE,
          bool PAGED, int DT>
int launch_heads(const Launch& a, cudaStream_t stream) {
  if (a.G == 1)
    return launch_rule<QT, CT, ST, QUANT, MODE, PAGED, 1, DT>(a, stream);
  if constexpr (MODE == FLASH_EW) {
    return (int)cudaErrorInvalidValue;  // K12 is MHA: G = 1
  } else {
    return launch_rule<QT, CT, ST, QUANT, MODE, PAGED, GQA_HEADS, DT>(a,
                                                                   stream);
  }
}

// The main path's types (bf16 q over an int8 cache) at D = 64 take the
// body with the head dim fixed at compile time (on an H100, K3 and K5 run
// 10-15% faster so than with it at run time); every other case the one
// with the head dim at run time.
template <typename QT, typename CT, typename ST, bool QUANT, int MODE,
          bool PAGED>
int launch_dim(const Launch& a, cudaStream_t stream) {
  if constexpr (QUANT && std::is_same<QT, bf16>::value) {
    if (a.D == 64)
      return launch_heads<QT, CT, ST, QUANT, MODE, PAGED, 64>(a, stream);
  }
  return launch_heads<QT, CT, ST, QUANT, MODE, PAGED, 0>(a, stream);
}

template <typename QT, typename CT, typename ST, bool QUANT, int MODE>
int launch(const Launch& a, cudaStream_t stream) {
  // The plan must be decode_plan's: R a multiple of 16 and of a block
  // step's rows, within MAX_ROWS, the splits covering the capacity, and
  // the scratch given.
  const int rb = NWARPS * (32 / lanes_per_row(a.D, sizeof(CT)));
  const Plan& pl = a.plan;
  if (a.D < 1 || a.D > 256 || a.G < 1 || pl.R < MIN_ROWS ||
      pl.R > MAX_ROWS || pl.R % 16 || pl.R % rb ||
      (long long)pl.splits * pl.R < (long long)a.rows.MAXP * a.rows.PS ||
      pl.splits > 65535 || a.B > 65535 ||
      !pl.part || !pl.tickets)
    return (int)cudaErrorInvalidValue;
  if constexpr (MODE == FUSED_APPEND || MODE == FLASH) {
    if (a.rows.table)
      return launch_dim<QT, CT, ST, QUANT, MODE, true>(a, stream);
  } else if (a.rows.table) {
    return (int)cudaErrorInvalidValue;  // K12 and K13 read a slot cache
  }
  return launch_dim<QT, CT, ST, QUANT, MODE, false>(a, stream);
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
int entry(const void* q, const void* k_new, const void* v_new,
          const void* cache_k, const void* cache_v, const void* k_scale,
          const void* v_scale, const void* slopes, const void* pos,
          const void* table, void* out, void* part, void* tickets,
          int pos_scalar, int layer, int B, int KV, int G, int P, int PS,
          int MAXP, int D, int R, int splits, float scale, int q_bf16,
          int cache_kind, int scale_bf16, void* stream) {
  Launch a{q, k_new, v_new, const_cast<void*>(cache_k),
           const_cast<void*>(cache_v), const_cast<void*>(k_scale),
           const_cast<void*>(v_scale), static_cast<const float*>(slopes),
           static_cast<const int*>(pos), out,
           Rows{static_cast<const int*>(table), layer, P, KV, PS, MAXP,
                PS > 0 && (PS & (PS - 1)) == 0 ? __builtin_ctz(PS) : -1},
           Plan{static_cast<float*>(part), static_cast<int*>(tickets), R,
                splits},
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
// int32 or null (then pos_scalar); out (B, H, D) in q's dtype; part the
// scratch (B, KV, splits, G, D + 2) f32 and tickets (B, KV) int32, zero, of
// the plan (R rows a split, splits covering MAXP*PS rows; decode_plan).
extern "C" int fused_decode_append(
    const void* q, const void* k_new, const void* v_new, void* cache_k,
    void* cache_v, void* k_scale, void* v_scale, const void* slopes,
    const void* pos, const void* table, void* out, void* part, void* tickets,
    int pos_scalar, int layer, int B, int KV, int G, int P, int PS, int MAXP,
    int D, int R, int splits, float scale, int q_bf16, int cache_kind,
    int scale_bf16, void* stream) {
  return entry<FUSED_APPEND>(q, k_new, v_new, cache_k, cache_v, k_scale,
                             v_scale, slopes, pos, table, out, part, tickets,
                             pos_scalar, layer, B, KV, G, P, PS, MAXP, D, R,
                             splits, scale, q_bf16, cache_kind, scale_bf16,
                             stream);
}

// The same arguments without k_new/v_new: attention over the cached rows
// s <= pos, nothing written but out. flash_decode (K11, K15); the slot
// cache only: flash_decode_ew (K12, G = 1) and flash_decode_bfold (K13).
#define FLASH_ENTRY(name, mode)                                              \
  extern "C" int name(const void* q, const void* cache_k,                   \
                      const void* cache_v, const void* k_scale,             \
                      const void* v_scale, const void* slopes,              \
                      const void* pos, const void* table, void* out,        \
                      void* part, void* tickets, int pos_scalar, int layer, \
                      int B, int KV, int G, int P, int PS, int MAXP, int D, \
                      int R, int splits, float scale, int q_bf16,           \
                      int cache_kind, int scale_bf16, void* stream) {       \
    return entry<mode>(q, nullptr, nullptr, cache_k, cache_v, k_scale,      \
                       v_scale, slopes, pos, table, out, part, tickets,     \
                       pos_scalar, layer, B, KV, G, P, PS, MAXP, D, R,      \
                       splits, scale, q_bf16, cache_kind, scale_bf16,       \
                       stream);                                             \
  }
FLASH_ENTRY(flash_decode, FLASH)
FLASH_ENTRY(flash_decode_ew, FLASH_EW)
FLASH_ENTRY(flash_decode_bfold, FLASH_BFOLD)
