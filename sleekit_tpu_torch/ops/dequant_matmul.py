"""Fused dequantize + matmul (port of ``sleekit_tpu/ops/dequant_matmul.py``).

``y = [residual +] pre(x) @ (lut[unpack(W)] * scale) + bias``, with the
packed words streamed from device memory and decoded on chip.

* :func:`dequant_matmul_ref` - unpack + dense f32 product, the oracle
  (``dequant_matmul_xla``).
* Kernel K1, :func:`pair_matmul` - the 'pair' layout
  (``_pallas_pair_impl``/``_pair_kernel``), CUDA in
  ``csrc/dequant_matmul.cu``.
* Kernels K6 and K7, :func:`pair3_matmul` (``layout='pair3x'`` or
  ``'pair3'``) - the 3-bit 'pair3x' and 'pair3' layouts (``_pair_kernel``
  with ``p3x`` / ``pair3``), K1's body under their own tile rules, same
  source.
* Kernel K2, :func:`int8_matmul` - the 'int8' layout
  (``_pallas_int8_impl``), same source.
* Kernels K8 and K9, :func:`plane_lut_matmul` and
  :func:`plane_affine_matmul` - the 'plane' layout (``_pallas_impl``:
  ``_kernel`` over a table, ``_mantissa_kernel`` over an affine grid),
  K1's two routes (``csrc/dequant_routes.cuh``) under the 'plane' tile
  rules in ``csrc/plane_matmul.cu``, for bf16 x; kernels K8f and K9f,
  the same wrappers at f32 x (the JAX kernels' f32 ``compute_dtype``),
  held to f32 accuracy, in ``csrc/plane_f32.cu``: split-TF32 products on
  the tensor cores (each operand as two TF32 halves, three products; two
  for K9f), a streaming route at M <= ``DECODE_M`` (:func:`f32_stream_plan`)
  and a tiled one above (:func:`f32_tile_plan`).

K1, K2, K6 and K7 fuse the prologue (layernorm/rmsnorm masked to the
valid K, relu, gelu, silu_glu) and the epilogue ``(a*acc + b*rowsum)*scale
+ bias [+ residual]``; K8 and K9 have no prologue, as in the JAX package.
Their plain versions (``*_plain``) repeat the kernels' own arithmetic:
``pre(x)`` in f32 rounded to bf16, ``rowsum`` over that bf16 ``pre(x)``,
f32 accumulation. K1 decodes ``C = 1 + idx/2^nbits`` (exact in bf16) as
the TPU kernel does, but accumulates over ``C - 1.5`` and folds ``b +
1.5a`` into the rowsum term: over C itself the fold cancels
catastrophically when x has a large mean (after relu), and its f32
rounding flips about one bf16 output in ten. K6, K7 and K9 centre the same
way (``_CENTRE``); the int8 layout is centred already, and K8's table is
not folded. At f32 x the plain versions of K8f and K9f keep f32
throughout: the table unrounded, x itself (no prologue), an f32 output.

The JAX package chunks prefill-size M through its kernel
(``PREFILL_CHUNK_M``, a TPU VMEM limit); the CUDA kernels tile M
themselves, so the port has no chunking. K1, K2 and K6-K9 share one
route rule, and one call is still one counted launch: a prologue pass
writes pre(x) (for K8 and K9, x itself) and its row sums once into
scratch that the wrappers allocate at every M (:func:`_scratch`); then
above ``DECODE_M`` rows a tensor-core kernel tiles the product (K2
converts its int8 bytes to bf16 tiles in shared memory), and up to
``DECODE_M`` rows a kernel streams the weight with 16-byte loads into
tensor-core products whose N is the tokens, K split over a block's warps
and, for K1 and K6-K9 where the column strips alone leave SMs idle,
over blocks (:func:`stream_plan`), the slices summed in a fixed order.
``LUT_POLY`` and ``PAIR_TUNE`` are the TPU kernels' schedules of the
same functions; the port accepts and ignores them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from sleekit_tpu_torch.kernels import CudaKernel, zeroed_tickets
from sleekit_tpu_torch.ops.pack import (
    PAIR3_TILE, PAIR3_WORDS, PAIR3X_GROUP, PAIR3X_WORDS, PLANE_GROUP,
    PackedLinear, unpack_indices, vals_per_word)
from sleekit_tpu_torch.parallel.comm_model import HBM_BPS

# TPU schedules (``sleekit_tpu/ops/dequant_matmul.py:479, 498``): read by
# nothing here, every setting gives the same answer.
LUT_POLY = False
PAIR_TUNE = {"kb": 0, "split": False, "dim_sem": False, "bn": 0, "p3m": 2}

_PRE = {None: 0, "layernorm": 1, "rmsnorm": 2, "relu": 3, "gelu": 4,
        "silu_glu": 5}

# K1, K2 and K6-K9 run a prologue pass into scratch (K rounded up to
# XP_CHUNK columns) at every M, then their streaming kernel up to DECODE_M
# rows and their tensor-core kernel above (``csrc/dequant_routes.cuh``:
# ``launch_pair_m``, ``MMA_KC``; ``csrc/dequant_matmul.cu``:
# ``launch_int8_m``).
DECODE_M = 8
XP_CHUNK = 64

# K1/K6-K9's streaming kernel (``pair_stream_kernel``): a block of
# STREAM_WARPS warps streams STREAM_COLS columns (``PAIR_COLS``) over its
# slice of K; K is split in units of word rows (:func:`stream_units`) so
# that the blocks come nearest to STREAM_BLOCKS_PER_SM an SM
# (:func:`stream_plan`; the SM count is the device's, H100_SMS without
# one).
STREAM_COLS = 32
STREAM_WARPS = 8
STREAM_BLOCKS_PER_SM = 2
H100_SMS = 132

# K8f/K9f's streaming route (``csrc/plane_f32.cu`` ``stream_tf32_kernel``,
# mma.sync with the decoded weight as the A operand and the tokens as the
# n8): a block of STREAM_WARPS warps, twice as many where K splits over
# blocks, streams F32_STREAM_COLS columns (two m16 tiles) over its slice
# of K, in units of F32_UNIT_ROWS word rows of one tile by up to 8 of
# their fields, one k8 step a field (:func:`f32_stream_units`). A strip's
# K splits form one thread block cluster, so they are a power of two, at
# most F32_MAX_CLUSTER (``COLS``, ``UNIT_ROWS``, ``NWARPS``,
# ``MAX_CLUSTER``).
F32_STREAM_COLS = 32
F32_UNIT_ROWS = 8
F32_MAX_CLUSTER = 8

# K8f/K9f's tiled route (``f32_tile_kernel``): a block computes F32_TILE_M
# rows by F32_TILE_N columns, 32 K rows a step, a step taking
# about F32_TILE_STEP_S seconds on an H100 (K8f's four projections of an
# OPT-1.3B layer at M = 2048 over their 1,536 waves of steps, PERF.md
# section 6); a K split over blocks gives each slice at least
# F32_TILE_MIN_STEPS steps and writes and reads back (splits, M, N) f32
# partials at the device memory's rate (``HBM_BPS``).
F32_TILE_M = F32_TILE_N = 128
F32_TILE_STEP_S = 1.5e-6
F32_TILE_MIN_STEPS = 16

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (x, words, scale, bias, ln_scale, ln_bias, ln_bf16, residual, out, xp, rs,
#  part, tickets, M, N, K, x_cols, kw, splits, nbits, pre, a, b, eps)
K1 = CudaKernel(
    "K1", "dequant_matmul.cu", "pair_matmul",
    [_P] * 6 + [_I] + [_P] * 6 + [_I] * 8 + [_F] * 3,
    replaces="sleekit_tpu/ops/dequant_matmul.py:515 _pallas_pair_impl")
# (x, words, scale, bias, ln_scale, ln_bias, ln_bf16, residual, out, xp, rs,
#  part, tickets, M, N, K, x_cols, kw, splits, pre, a, b, eps)
K6 = CudaKernel(
    "K6", "dequant_matmul.cu", "pair3x_matmul",
    [_P] * 6 + [_I] + [_P] * 6 + [_I] * 7 + [_F] * 3,
    replaces="sleekit_tpu/ops/dequant_matmul.py:515 _pallas_pair_impl "
             "(p3x=True)")
K7 = CudaKernel(
    "K7", "dequant_matmul.cu", "pair3_matmul",
    [_P] * 6 + [_I] + [_P] * 6 + [_I] * 7 + [_F] * 3,
    replaces="sleekit_tpu/ops/dequant_matmul.py:515 _pallas_pair_impl "
             "(pair3=True)")
# (x, w8, scale, bias, ln_scale, ln_bias, ln_bf16, residual, out, xp, rs,
#  M, N_out, K, Kp, Np, pre, a, b, eps)
K2 = CudaKernel(
    "K2", "dequant_matmul.cu", "int8_matmul",
    [_P] * 6 + [_I] + [_P] * 4 + [_I] * 6 + [_F] * 3,
    replaces="sleekit_tpu/ops/dequant_matmul.py:664 _pallas_int8_impl")
# (x, words, scale, bias, lut, out, xp, rs, part, tickets, M, N, K, kw,
#  splits, nbits, ksize, step, zero)
K8 = CudaKernel(
    "K8", "plane_matmul.cu", "plane_lut_matmul",
    [_P] * 10 + [_I] * 7 + [_F] * 2,
    replaces="sleekit_tpu/ops/dequant_matmul.py:771 _pallas_impl "
             "(_kernel, table)")
# (x, words, scale, bias, out, xp, rs, part, tickets, M, N, K, kw, splits,
#  nbits, a, b)
K9 = CudaKernel(
    "K9", "plane_matmul.cu", "plane_affine_matmul",
    [_P] * 9 + [_I] * 6 + [_F] * 2,
    replaces="sleekit_tpu/ops/dequant_matmul.py:771 _pallas_impl "
             "(_mantissa_kernel)")
# (x, words, scale, bias, lut, out, part, tickets, M, N, K, kw, splits,
#  nbits, ksize, step, zero)
K8f = CudaKernel(
    "K8f", "plane_f32.cu", "plane_lut_matmul_f32",
    [_P] * 8 + [_I] * 7 + [_F] * 2,
    replaces="sleekit_tpu/ops/dequant_matmul.py:771 _pallas_impl "
             "(_kernel, table, f32 compute_dtype :821)")
# (x, words, scale, bias, out, part, tickets, M, N, K, kw, splits, nbits,
#  a, b)
K9f = CudaKernel(
    "K9f", "plane_f32.cu", "plane_affine_matmul_f32",
    [_P] * 7 + [_I] * 6 + [_F] * 2,
    replaces="sleekit_tpu/ops/dequant_matmul.py:771 _pallas_impl "
             "(_mantissa_kernel, f32 compute_dtype :821)")

# Offset of each layout's centred weight: the kernels accumulate over the
# decoded weight minus this midpoint of its range (exact in f32), so the
# rowsum coefficient grows by a times it. 'pair'/'plane' decode C = 1 +
# idx/2^nbits (midpoint 1.5); the JAX 'pair3' kernel c_lo + 2*c_hi = 3 +
# idx/4 and its 'pair3x' kernel, after its section-weighted rowsum, idx/4
# (both centred on idx/4 - 0.875).
_CENTRE = {"pair": 1.5, "plane": 1.5, "pair3": 3.875, "pair3x": 0.875}


def _check_unsplit(w: PackedLinear) -> None:
    if w.k_splits != 1:
        raise ValueError(
            f"k_splits > 1 ({w.k_splits}): split_packed_k matrices are a "
            "tensor-parallel sharding format; localize the shard "
            "(ops/pack.localize_packed_shard) before the matmul")


def dequant_matmul_ref(x: torch.Tensor, w: PackedLinear) -> torch.Tensor:
    """Correctness oracle: dense f32 dequantized weight, f32 product."""
    _check_unsplit(w)
    y = x.float() @ w.dequantize()
    if w.bias is not None:
        y = y + w.bias[None, :]
    return y.to(x.dtype)


def _int8_affine(w: PackedLinear):
    """(a, b) of the signed-int8 fold: deq = (a*v + b)*scale, v = idx-128."""
    step, zero = w.affine
    return step, zero + 128.0 * step


def _pair_affine(w: PackedLinear):
    """(a, b) of out = (a*acc + b*rowsum)*scale + bias as the JAX package
    folds it: for 'pair' and 'plane' acc = x @ C, C = 1 + idx/2^nbits;
    for 'pair3' acc = x@c_lo + 2x@c_hi (c_lo = 1 + lo/4, c_hi = 1 + hi/2);
    for 'pair3x' acc = x @ idx/4 (after the section-weighted rowsum)."""
    step, zero = w.affine
    if w.layout == "pair3":
        return 4.0 * step, zero - 12.0 * step
    if w.layout == "pair3x":
        return 4.0 * step, zero
    a = step * float(2 ** w.nbits)
    return a, zero - a


def _centred(a_aff: float, b_aff: float, layout: str = "pair") -> float:
    """The rowsum coefficient when acc runs over the centred weight, in
    double, once rounded to f32 by the caller (zero + step/2 for 'pair',
    zero + 3.5*step for the 3-bit layouts: small)."""
    return b_aff + _CENTRE[layout] * a_aff


# ---- plain versions of K1 / K2 --------------------------------------------


def _prologue_plain(x, pre, ln_scale, ln_bias, eps, k):
    """pre(x) in f32, rounded to bf16 - the kernels' prologue."""
    if pre == "silu_glu":
        return (F.silu(x[:, :k].float()) * x[:, k:2 * k].float()).to(
            torch.bfloat16)
    x32 = x.float()
    if pre in ("layernorm", "rmsnorm"):
        if pre == "layernorm":
            xc = x32 - x32.sum(dim=1, keepdim=True) / k
        else:
            xc = x32
        var = (xc * xc).sum(dim=1, keepdim=True) / k
        xn = xc * torch.rsqrt(var + eps) * ln_scale.float()
        if ln_bias is not None:
            xn = xn + ln_bias.float()
        return xn.to(torch.bfloat16)
    if pre == "relu":
        return torch.clamp(x, min=0).to(torch.bfloat16)
    if pre == "gelu":
        return F.gelu(x32, approximate="tanh").to(torch.bfloat16)
    if pre is not None:
        raise ValueError(f"unknown prologue {pre!r}")
    return x.to(torch.bfloat16)


def _epilogue_plain(acc, xp, a, b, scale, bias, residual):
    out = (a * acc + b * xp.float().sum(dim=1, keepdim=True)) * scale
    if bias is not None:
        out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(torch.bfloat16)


def pair_matmul_plain(x, packed, scale, bias, *, nbits, k, a_aff, b_aff,
                      pre=None, ln_scale=None, ln_bias=None, eps=1e-5,
                      residual=None):
    """Plain PyTorch version of kernel K1 (same arithmetic)."""
    xp = _prologue_plain(x, pre, ln_scale, ln_bias, eps, k)
    idx = unpack_indices(packed, nbits, k, layout="pair")
    c = idx.float() / float(2 ** nbits) - 0.5        # C - 1.5, exact
    return _epilogue_plain(xp.float() @ c, xp, a_aff, _centred(a_aff, b_aff),
                           scale, bias, residual)


def pair3_matmul_plain(x, packed, scale, bias, *, k, a_aff, b_aff,
                       pre=None, ln_scale=None, ln_bias=None, eps=1e-5,
                       residual=None, layout="pair3"):
    """Plain PyTorch version of kernels K7 ('pair3') and K6 ('pair3x'):
    both accumulate over idx/4 - 0.875 (the kernels' 2*(C - 1.4375) with
    C = 1 + idx/8 built from a pair3 index's low and high words, and
    pair3x's 4-bit field 4 + idx/4 minus 4.875; exact)."""
    xp = _prologue_plain(x, pre, ln_scale, ln_bias, eps, k)
    idx = unpack_indices(packed, 3, k, layout=layout)
    c = idx.float() / 4.0 - 0.875
    return _epilogue_plain(xp.float() @ c, xp, a_aff,
                           _centred(a_aff, b_aff, layout), scale, bias,
                           residual)


def _k8_table(lut, nbits, affine, rounded=True):
    """K8's value of each of the 2^nbits indices, held as f32: ``lut`` and
    0 past its end, or for an affine codebook ``idx*step + zero`` in f32;
    rounded to bf16 (``rounded``, K8's bf16 operands) or not (K8f)."""
    size = 2 ** nbits
    if affine is not None:
        step, zero = (torch.tensor(v, dtype=torch.float32) for v in affine)
        vals = torch.arange(size, dtype=torch.float32) * step + zero
    else:
        vals = torch.zeros(size, dtype=torch.float32)
        vals[:lut.shape[0]] = lut.detach().float().cpu()
    return vals.to(torch.bfloat16).float() if rounded else vals


def plane_lut_matmul_plain(x, packed, scale, bias, lut, *, nbits, k,
                           affine=None):
    """Plain PyTorch version of kernel K8 (bf16 x): ``bf16((x @
    bf16(table[idx])) * scale + bias)`` over 'plane' words, f32
    accumulation; and of K8f (f32 x): ``(x @ table[idx]) * scale + bias``
    in f32 with the table unrounded (:func:`_k8_table`)."""
    f32 = x.dtype == torch.float32
    idx = unpack_indices(packed, nbits, k, layout="plane").long()
    table = _k8_table(lut, nbits, affine, rounded=not f32).to(x.device)
    out = (x.float() @ table[idx]) * scale
    if bias is not None:
        out = out + bias.float()
    return out if f32 else out.to(torch.bfloat16)


def plane_affine_matmul_plain(x, packed, scale, bias, *, nbits, k, a_aff,
                              b_aff):
    """Plain PyTorch version of kernel K9 (bf16 x): K1's fold over 'plane'
    words (``C - 1.5`` with ``C = 1 + idx/2^nbits``), no prologue; and of
    K9f (f32 x): ``(a*(x @ (C - 1.5)) + b*rowsum(x))*scale + bias`` in
    f32."""
    idx = unpack_indices(packed, nbits, k, layout="plane")
    c = idx.float() / float(2 ** nbits) - 0.5        # C - 1.5, exact
    b_c = _centred(a_aff, b_aff, "plane")
    if x.dtype != torch.float32:
        return _epilogue_plain(x.float() @ c, x, a_aff, b_c, scale, bias,
                               None)
    out = (a_aff * (x @ c) + b_c * x.sum(dim=1, keepdim=True)) * scale
    return out if bias is None else out + bias


def int8_matmul_plain(x, packed, scale, bias, *, k, out_n, a_aff, b_aff,
                      pre=None, ln_scale=None, ln_bias=None, eps=1e-5,
                      residual=None):
    """Plain PyTorch version of kernel K2 (same arithmetic)."""
    xp = _prologue_plain(x, pre, ln_scale, ln_bias, eps, k)
    w8 = packed[:k, :out_n].float()
    bias = None if bias is None else bias[:out_n]
    return _epilogue_plain(xp.float() @ w8, xp, a_aff, b_aff,
                           scale[:out_n], bias, residual)


# ---- kernel wrappers ------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def plane_unit_steps(nbits: int) -> int:
    """Fields (k16 steps) a unit of the 'plane' streaming kernel takes of
    its 16 word rows: all of a word's fields, but 8 at 1 and 2 bits
    (``csrc/plane_matmul.cu`` ``Plane::STEPS``)."""
    vpw = vals_per_word(nbits)
    return 8 if vpw > 10 else vpw


def stream_units(kw: int, layout: str, nbits: int = 0) -> int:
    """Units of word rows that the streaming kernel of K1, K6-K9 walks K
    in, each word loaded once for all the unit's steps (``csrc``
    ``stream_units``): 'pair' 8 word rows of a tile, 'pair3' half a tile's
    low words with its high words, 'pair3x' six per 512-row group (four
    eights of 4-bit words, the pair3 tile's two halves), 'plane' (of
    ``nbits``) half a tile's 16 word rows by :func:`plane_unit_steps`
    fields."""
    if layout == "pair":
        return kw // 8
    if layout == "pair3":
        return kw // PAIR3_WORDS * 2
    if layout == "plane":
        return kw // 16 * (vals_per_word(nbits) // plane_unit_steps(nbits))
    return kw // PAIR3X_WORDS * 6


def _splits(strips: int, units: int, sms: int) -> int:
    """K splits over blocks of a streaming kernel's ``strips`` column
    strips and ``units`` units of K: nearest STREAM_BLOCKS_PER_SM blocks
    an SM (so at least one an SM), but never so many that a warp of a
    slice has no unit (K too short: one split)."""
    most = max(1, units // STREAM_WARPS)
    want = (2 * STREAM_BLOCKS_PER_SM * sms + strips) // (2 * strips)
    return max(1, min(most, want))


def stream_plan(n: int, kw: int, layout: str, sms: int = H100_SMS,
                nbits: int = 0):
    """(strips, splits) of the streaming kernel of K1, K6-K9 over (kw, n)
    words (``nbits`` for 'plane'): STREAM_COLS-column strips and
    :func:`_splits` over its units. The partial sums' scratch is (splits,
    M, n) f32 with one int32 ticket a strip; none at one split."""
    strips = -(-n // STREAM_COLS)
    return strips, _splits(strips, stream_units(kw, layout, nbits), sms)


def f32_stream_units(kw: int, nbits: int) -> int:
    """Units of K8f/K9f's streaming route over kw word rows: F32_UNIT_ROWS
    word rows by :func:`plane_unit_steps` fields (``Rule::STEPS``)."""
    return (kw // F32_UNIT_ROWS
            * (vals_per_word(nbits) // plane_unit_steps(nbits)))


def f32_stream_plan(n: int, kw: int, nbits: int, sms: int = H100_SMS):
    """(strips, splits) of K8f/K9f's streaming route over (kw, n) 'plane'
    words of ``nbits``: F32_STREAM_COLS-column strips, and K split into
    the largest power of two, at most F32_MAX_CLUSTER, that keeps the
    blocks within one an SM and gives each of a split block's 2 x
    STREAM_WARPS warps at least one unit. A strip's splits are one
    cluster, whose blocks sum through distributed shared memory (no
    scratch, no tickets); within one block an SM every cluster is
    resident at once (on an H100 only 62 clusters of 4 blocks are, where
    OPT-1.3B's 64 strips of N = 2048 need 64)."""
    strips = -(-n // F32_STREAM_COLS)
    units = f32_stream_units(kw, nbits)
    splits = 1
    while (2 * splits <= F32_MAX_CLUSTER and strips * 2 * splits <= sms
           and units >= 2 * splits * 2 * STREAM_WARPS):
        splits *= 2
    return strips, splits


def f32_tile_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> int:
    """The K splits over blocks of K8f/K9f's tiled route for x (m, k) by a
    (k, n) weight: of 1 to ceil(2 sms / tiles) slices of at least
    F32_TILE_MIN_STEPS steps of 32 rows, the count that finishes first,
    counted as waves of blocks over the SMs times a block's steps times
    F32_TILE_STEP_S, plus the partials' traffic above one split; ties take
    fewer splits. Above one split the scratch holds the (splits, m, n) f32
    partials (and, for K9f, the (splits, strips, m) row sums), with one
    ticket a tile."""
    tiles = -(-m // F32_TILE_M) * -(-n // F32_TILE_N)
    steps = -(-k // 32)
    top = max(1, min(steps // F32_TILE_MIN_STEPS, -(-2 * sms // tiles)))

    def cost(splits):
        run = (-(-tiles * splits // sms) * -(-steps // splits)
               * F32_TILE_STEP_S)
        io = 0.0 if splits == 1 else (splits + 1) * m * n * 4
        return run + io / HBM_BPS
    return min(range(1, top + 1), key=cost)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _scratch_layout(m: int, k: int, n: int = 0, kw: int = 0,
                    layout: Optional[str] = None, sms: int = H100_SMS,
                    nbits: int = 0):
    """(cols, splits, rs, part, tickets, size): one call's scratch, in
    bytes from its start. pre(x) as bf16 (m, cols) at 0, cols = K rounded
    up to XP_CHUNK (16-byte rows), its f32 row sums at ``rs``; for K1 and
    K6-K9 (``layout`` given, with ``nbits`` for 'plane') at m <= DECODE_M
    over more than one split (:func:`stream_plan`), the f32 partials
    (splits, m, n) at ``part`` and one int32 ticket a strip at
    ``tickets`` (0 where absent)."""
    cols = -(-k // XP_CHUNK) * XP_CHUNK
    rs = m * cols * 2
    size = rs + -(-m * 4 // 16) * 16
    splits, part, tickets = 1, 0, 0
    if layout is not None and m <= DECODE_M:
        strips, splits = stream_plan(n, kw, layout, sms, nbits)
        if splits > 1:
            part, tickets = size, size + 4 * splits * m * n
            size = tickets + 4 * strips
    return cols, splits, rs, part, tickets, size


def _scratch(x: torch.Tensor, k: int, n: int = 0, kw: int = 0,
             layout: Optional[str] = None, nbits: int = 0):
    """One device buffer for a call's scratch (:func:`_scratch_layout`,
    with the device's SM count): (the buffer, splits, and the addresses
    of xp, rs, the partials and the tickets, 0 where absent). One
    allocation a call keeps the host's share of an eager decode step
    small."""
    m = x.shape[0]
    sms = (_sms(x.device.index or 0) if layout is not None
           and m <= DECODE_M else H100_SMS)
    _, splits, rs, part, tickets, size = _scratch_layout(m, k, n, kw, layout,
                                                          sms, nbits)
    buf = torch.empty(size, dtype=torch.uint8, device=x.device)
    p = buf.data_ptr()
    return (buf, splits, p, p + rs, p + part if part else 0,
            p + tickets if tickets else 0)


def _f32_scratch(x: torch.Tensor, n: int, k: int, kw: int, nbits: int,
                 rows: bool):
    """K8f/K9f's scratch and plan, with the device's SM count: at M <=
    DECODE_M :func:`f32_stream_plan` (a cluster along K: no scratch),
    above :func:`f32_tile_plan`, over more than one split one f32 buffer
    of the partials (with the row sums for K9f, ``rows``) and the device's
    zeroed tickets (one a tile). Returns (the buffer, splits, the
    addresses of the partials and the tickets, 0 where absent)."""
    m = x.shape[0]
    sms = _sms(x.device.index or 0)
    if m <= DECODE_M:
        return None, f32_stream_plan(n, kw, nbits, sms)[1], 0, 0
    strips, splits = -(-n // F32_TILE_N), f32_tile_plan(m, n, k, sms)
    tickets = -(-m // F32_TILE_M) * strips
    if splits == 1:
        return None, 1, 0, 0
    buf = torch.empty(splits * m * (n + (strips if rows else 0)),
                      dtype=torch.float32, device=x.device)
    return (buf, splits, buf.data_ptr(),
            zeroed_tickets(tickets, x.device).data_ptr())


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(x, k, scale, bias, pre, ln_scale, ln_bias, residual, n,
                  dtype=torch.bfloat16):
    dev = x.device
    _check(x.dtype == dtype and x.dim() == 2 and x.is_contiguous(),
           "x must be a contiguous 2-D "
           f"{'f32' if dtype == torch.float32 else 'bf16'} tensor")
    _check(pre in _PRE, f"unknown prologue {pre!r}")
    _check(x.shape[1] == (2 * k if pre == "silu_glu" else k),
           f"x has {x.shape[1]} columns for K={k} and prologue {pre!r}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            _check(t.device == dev and t.dtype == torch.float32
                   and t.is_contiguous() and t.numel() >= n,
                   f"{name} must be a contiguous f32 vector of >= {n} on "
                   "x's device")
    ln_bf16 = 0
    if pre in ("layernorm", "rmsnorm"):
        _check(ln_scale is not None, "norm prologue needs ln_scale")
        ln_bf16 = int(ln_scale.dtype == torch.bfloat16)
        for t in (ln_scale, ln_bias):
            if t is not None:
                _check(t.device == dev and t.is_contiguous()
                       and t.shape == (k,)
                       and t.dtype in (torch.float32, torch.bfloat16)
                       and t.dtype == ln_scale.dtype,
                       "ln_scale/ln_bias must be contiguous (K,) f32 or "
                       "bf16 vectors of one dtype")
    if residual is not None:
        _check(residual.dtype == torch.bfloat16 and residual.is_contiguous()
               and residual.shape == (x.shape[0], n)
               and residual.device == dev,
               "residual must be a contiguous bf16 (M, N) tensor")
    return ln_bf16


def pair_matmul(x, packed, scale, bias, *, nbits, k, a_aff, b_aff,
                pre=None, ln_scale=None, ln_bias=None, eps=1e-5,
                residual=None):
    """Kernel K1: ``[res +] (a*(pre(x) @ C) + b*rowsum(pre(x)))*scale +
    bias`` over (kw, N) 'pair' words; bf16 out. A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`pair_matmul_plain`."""
    if not x.is_cuda:
        return pair_matmul_plain(
            x, packed, scale, bias, nbits=nbits, k=k, a_aff=a_aff,
            b_aff=b_aff, pre=pre, ln_scale=ln_scale, ln_bias=ln_bias,
            eps=eps, residual=residual)
    kw, n = packed.shape
    _check(1 <= nbits <= 7, "the pair kernel takes 1..7-bit indices")
    _check(packed.dtype == torch.int32 and packed.is_contiguous()
           and packed.device == x.device,
           "packed must be contiguous int32 words on x's device")
    hp = 16 // nbits
    pg = 32 * (2 if hp % 2 else 1)
    _check(kw % pg == 0 and kw // pg * 2 * pg * hp >= k,
           f"packed has {kw} word rows, not whole pair tiles covering K={k}")
    ln_bf16 = _check_common(x, k, scale, bias, pre, ln_scale, ln_bias,
                            residual, n)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _buf, splits, xp, rs, part, tickets = _scratch(x, k, n, kw, "pair")
    K1(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
       _ptr(ln_scale), _ptr(ln_bias), ln_bf16, _ptr(residual),
       out.data_ptr(), xp, rs, part, tickets, m, n, k, x.shape[1], kw,
       splits, nbits, _PRE[pre], float(a_aff), _centred(a_aff, b_aff),
       float(eps))
    return out


def pair3_matmul(x, packed, scale, bias, *, k, a_aff, b_aff, pre=None,
                 ln_scale=None, ln_bias=None, eps=1e-5, residual=None,
                 layout="pair3"):
    """Kernels K7 ('pair3', 256-row tiles of 24 words) and K6 ('pair3x',
    512-row groups of 56 words, K % 512 == 0): K1's prologue and epilogue
    with the JAX package's (a, b) of the layout. A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`pair3_matmul_plain`."""
    if not x.is_cuda:
        return pair3_matmul_plain(
            x, packed, scale, bias, k=k, a_aff=a_aff, b_aff=b_aff, pre=pre,
            ln_scale=ln_scale, ln_bias=ln_bias, eps=eps, residual=residual,
            layout=layout)
    _check(layout in ("pair3", "pair3x"), f"not a 3-bit layout: {layout!r}")
    kernel, pg, bk = ((K6, PAIR3X_WORDS, PAIR3X_GROUP) if layout == "pair3x"
                      else (K7, PAIR3_WORDS, PAIR3_TILE))
    kw, n = packed.shape
    _check(packed.dtype == torch.int32 and packed.is_contiguous()
           and packed.device == x.device,
           "packed must be contiguous int32 words on x's device")
    _check(kw % pg == 0 and kw // pg * bk >= k,
           f"packed has {kw} word rows, not whole {layout} tiles covering "
           f"K={k}")
    _check(layout == "pair3" or kw // pg * bk == k,
           f"pair3x requires K % {PAIR3X_GROUP} == 0 and one group per 512 "
           f"rows (K={k}, {kw} word rows); use layout='pair3'")
    ln_bf16 = _check_common(x, k, scale, bias, pre, ln_scale, ln_bias,
                            residual, n)
    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _buf, splits, xp, rs, part, tickets = _scratch(x, k, n, kw, layout)
    kernel(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
           _ptr(ln_scale), _ptr(ln_bias), ln_bf16, _ptr(residual),
           out.data_ptr(), xp, rs, part, tickets, m, n, k, x.shape[1], kw,
           splits, _PRE[pre], float(a_aff), _centred(a_aff, b_aff, layout),
           float(eps))
    return out


def _check_plane(x, packed, scale, bias, nbits, k):
    """(kw, N) of a 'plane' call on bf16 x (K8, K9) or f32 x (K8f, K9f)."""
    kw, n = packed.shape
    _check(packed.dtype == torch.int32 and packed.is_contiguous()
           and packed.device == x.device,
           "packed must be contiguous int32 words on x's device")
    vpw = vals_per_word(nbits)
    _check(kw % PLANE_GROUP == 0 and kw * vpw >= k,
           f"packed has {kw} word rows, not whole plane tiles covering "
           f"K={k}")
    _check_common(x, k, scale, bias, None, None, None, None, n,
                  torch.float32 if x.dtype == torch.float32
                  else torch.bfloat16)
    return kw, n


def plane_lut_matmul(x, packed, scale, bias, lut, *, nbits, k,
                     affine=None):
    """Kernel K8: ``bf16((x @ bf16(v[idx])) * scale + bias)`` over 'plane'
    words, with v the codebook ``lut`` (any size up to 2^nbits, any order)
    or, for an affine codebook (8 bits), ``idx*step + zero``; one counted
    launch of the prologue pass and the streaming (M <= DECODE_M) or
    tensor-core kernel. At f32 x, kernel K8f: ``(x @ v[idx]) * scale +
    bias`` in f32, v unrounded, one counted launch of its streaming or
    tiled kernel. A CUDA tensor launches the kernel; a CPU tensor takes
    :func:`plane_lut_matmul_plain`."""
    if not x.is_cuda:
        return plane_lut_matmul_plain(x, packed, scale, bias, lut,
                                      nbits=nbits, k=k, affine=affine)
    kw, n = _check_plane(x, packed, scale, bias, nbits, k)
    if affine is None:
        _check(lut.dtype == torch.float32 and lut.is_contiguous()
               and lut.device == x.device and lut.dim() == 1
               and 1 <= lut.shape[0] <= 2 ** nbits,
               f"lut must be a contiguous f32 vector of at most 2^{nbits} "
               "values on x's device")
    step, zero = affine if affine is not None else (0.0, 0.0)
    m = x.shape[0]
    lut_ptr = 0 if affine is not None else lut.data_ptr()
    ksize = 0 if affine is not None else lut.shape[0]
    if x.dtype == torch.float32:
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        _buf, splits, part, tickets = _f32_scratch(x, n, k, kw, nbits, False)
        K8f(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
            lut_ptr, out.data_ptr(), part, tickets, m, n, k, kw, splits,
            nbits, ksize, float(step), float(zero))
        return out
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _buf, splits, xp, rs, part, tickets = _scratch(x, k, n, kw, "plane",
                                                   nbits)
    K8(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
       lut_ptr, out.data_ptr(), xp, rs, part, tickets, m, n, k, kw, splits,
       nbits, ksize, float(step), float(zero))
    return out


def plane_affine_matmul(x, packed, scale, bias, *, nbits, k, a_aff, b_aff):
    """Kernel K9: ``bf16((a*(x @ C) + b*rowsum(x))*scale + bias)`` over
    'plane' words, ``C = 1 + idx/2^nbits`` (nbits <= 7), launched as K8
    is; at f32 x, kernel K9f, the same in f32 (launched as K8f is). A CUDA
    tensor launches the kernel; a CPU tensor takes
    :func:`plane_affine_matmul_plain`."""
    if not x.is_cuda:
        return plane_affine_matmul_plain(x, packed, scale, bias, nbits=nbits,
                                         k=k, a_aff=a_aff, b_aff=b_aff)
    _check(nbits <= 7, "the mantissa kernel takes at most 7-bit indices")
    kw, n = _check_plane(x, packed, scale, bias, nbits, k)
    m = x.shape[0]
    if x.dtype == torch.float32:
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        _buf, splits, part, tickets = _f32_scratch(x, n, k, kw, nbits, True)
        K9f(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
            out.data_ptr(), part, tickets, m, n, k, kw, splits, nbits,
            float(a_aff), _centred(a_aff, b_aff, "plane"))
        return out
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    _buf, splits, xp, rs, part, tickets = _scratch(x, k, n, kw, "plane",
                                                   nbits)
    K9(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
       out.data_ptr(), xp, rs, part, tickets, m, n, k, kw, splits, nbits,
       float(a_aff), _centred(a_aff, b_aff, "plane"))
    return out


def int8_matmul(x, packed, scale, bias, *, k, out_n, a_aff, b_aff,
                pre=None, ln_scale=None, ln_bias=None, eps=1e-5,
                residual=None):
    """Kernel K2: the K1 epilogue over pre-padded signed int8 (Kp, Np)
    weights, output sliced to ``out_n`` columns; one call is one counted
    launch of the prologue pass and the streaming (M <= DECODE_M) or
    tensor-core kernel. A CUDA tensor launches the kernel; a CPU tensor
    takes :func:`int8_matmul_plain`."""
    if not x.is_cuda:
        return int8_matmul_plain(
            x, packed, scale, bias, k=k, out_n=out_n, a_aff=a_aff,
            b_aff=b_aff, pre=pre, ln_scale=ln_scale, ln_bias=ln_bias,
            eps=eps, residual=residual)
    kp, np_ = packed.shape
    _check(pre != "silu_glu", "GLU fusion is pair-layout only")
    _check(packed.dtype == torch.int8 and packed.dim() == 2
           and packed.is_contiguous() and packed.device == x.device,
           "packed must be contiguous (Kp, Np) int8 on x's device")
    _check(kp >= k and out_n <= np_,
           f"int8 weights {tuple(packed.shape)} do not cover K={k}, "
           f"N={out_n}")
    ln_bf16 = _check_common(x, k, scale, bias, pre, ln_scale, ln_bias,
                            residual, out_n)
    m = x.shape[0]
    out = torch.empty((m, out_n), dtype=torch.bfloat16, device=x.device)
    _buf, _, xp, rs, _, _ = _scratch(x, k)
    K2(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
       _ptr(ln_scale), _ptr(ln_bias), ln_bf16, _ptr(residual),
       out.data_ptr(), xp, rs, m, out_n, k, kp, np_, _PRE[pre],
       float(a_aff), float(b_aff), float(eps))
    return out


# ---- dispatch -------------------------------------------------------------


def can_fuse_glue(x: torch.Tensor, w: PackedLinear) -> bool:
    """Whether K1/K2/K6/K7 take this matmul (and so its prologue/residual
    fusion): bf16 activations, an affine codebook, and the pair (<= 7
    bits), pair3, pair3x or int8 layout. At f32 these layouts take
    :func:`dequant_matmul_ref`, as the JAX package takes its XLA route;
    'plane' takes K8/K9 (bf16) or K8f/K9f (f32) through
    :func:`quantized_matmul`, its norm and activation composed around
    them."""
    ok_pair = w.layout in ("pair", "pair3", "pair3x") and w.nbits <= 7
    ok_int8 = w.layout == "int8" and w.nbits == 8
    return ((ok_pair or ok_int8) and w.affine is not None
            and x.dtype == torch.bfloat16 and w.k_splits == 1)


def _kernel_matmul(x, w, use_kernel, pre=None, ln_scale=None, ln_bias=None,
                   eps=1e-5, residual=None):
    """K1/K2/K6/K7 (``use_kernel``) or their plain versions."""
    kw = dict(pre=pre, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps,
              residual=residual)
    if w.layout == "int8":
        a, b = _int8_affine(w)
        fn = int8_matmul if use_kernel else int8_matmul_plain
        return fn(x, w.packed, w.scale, w.bias, k=w.in_features,
                  out_n=w.out_features, a_aff=a, b_aff=b, **kw)
    a, b = _pair_affine(w)
    if w.layout in ("pair3", "pair3x"):
        fn = pair3_matmul if use_kernel else pair3_matmul_plain
        return fn(x, w.packed, w.scale, w.bias, k=w.in_features, a_aff=a,
                  b_aff=b, layout=w.layout, **kw)
    fn = pair_matmul if use_kernel else pair_matmul_plain
    return fn(x, w.packed, w.scale, w.bias, nbits=w.nbits, k=w.in_features,
              a_aff=a, b_aff=b, **kw)


def _plane_matmul(x, w, use_kernel):
    """'plane' weights with bf16 or f32 x: K9 (K9f) for an affine codebook
    of at most 7 bits, K8 (K8f) for a table or 8 bits (or their plain
    versions)."""
    if w.affine is not None and w.nbits <= 7:
        a, b = _pair_affine(w)
        fn = plane_affine_matmul if use_kernel else plane_affine_matmul_plain
        return fn(x, w.packed, w.scale, w.bias, nbits=w.nbits,
                  k=w.in_features, a_aff=a, b_aff=b)
    fn = plane_lut_matmul if use_kernel else plane_lut_matmul_plain
    return fn(x, w.packed, w.scale, w.bias, w.lut, nbits=w.nbits,
              k=w.in_features, affine=w.affine)


def quantized_matmul(x: torch.Tensor, w: PackedLinear,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """y = x @ deq(w) + bias. Matmuls that a kernel takes run it when
    ``use_kernel`` (default: x is on CUDA), else its plain version: bf16 x
    over the pair, pair3, pair3x and int8 layouts with an affine codebook
    (K1, K6, K7, K2), and bf16 or f32 x over 'plane' (K8/K9, K8f/K9f), as
    the JAX package sends 'plane' to its Pallas kernel at either dtype.
    The rest run :func:`dequant_matmul_ref`: f32 x over the pair*, int8
    and linear layouts (the JAX package's XLA route). A ``k_splits > 1``
    matrix raises, as the JAX package's matmuls do."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    _check_unsplit(w)
    if can_fuse_glue(x, w):
        return _kernel_matmul(x.contiguous(), w, use_kernel)
    if w.layout == "plane" and x.dtype in (torch.bfloat16, torch.float32):
        return _plane_matmul(x.contiguous(), w, use_kernel)
    return dequant_matmul_ref(x, w)


def fused_quantized_matmul(x: torch.Tensor, w: PackedLinear, *,
                           pre: Optional[str] = None,
                           ln_scale: Optional[torch.Tensor] = None,
                           ln_bias: Optional[torch.Tensor] = None,
                           eps: float = 1e-5,
                           residual: Optional[torch.Tensor] = None,
                           use_kernel: Optional[bool] = None
                           ) -> torch.Tensor:
    """``y = [residual +] pre(x) @ deq(w) + bias``: one K1/K2/K6/K7 launch
    (or its plain version, see :func:`quantized_matmul`) where the kernels
    take the matmul; otherwise the same math composed from PyTorch ops
    around :func:`quantized_matmul`."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if can_fuse_glue(x, w):
        return _kernel_matmul(
            x.contiguous(), w, use_kernel, pre=pre, ln_scale=ln_scale,
            ln_bias=ln_bias, eps=eps,
            residual=None if residual is None else residual.contiguous())
    h32 = x.float()
    if pre == "layernorm":
        mu = h32.mean(dim=-1, keepdim=True)
        var = h32.var(dim=-1, keepdim=True, unbiased=False)
        h32 = (h32 - mu) * torch.rsqrt(var + eps) * ln_scale
        if ln_bias is not None:
            h32 = h32 + ln_bias
    elif pre == "rmsnorm":
        var = (h32 * h32).mean(dim=-1, keepdim=True)
        h32 = h32 * torch.rsqrt(var + eps) * ln_scale
    elif pre == "relu":
        h32 = torch.clamp(h32, min=0)
    elif pre == "gelu":
        h32 = F.gelu(h32, approximate="tanh")
    elif pre == "silu_glu":
        kk = h32.shape[-1] // 2
        h32 = F.silu(h32[..., :kk]) * h32[..., kk:]
    y = quantized_matmul(h32.to(x.dtype), w, use_kernel=use_kernel)
    if residual is not None:
        y = y + residual
    return y
