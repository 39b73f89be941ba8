"""Decode and prefill attention (port of ``sleekit_tpu/ops/attention.py``).

The KV cache is (L, B, KV, S, D) with int8 scale planes (L, B, KV, S);
kernels take a layer index, so no per-layer slice is ever copied.

* :func:`kv_append_ref` / :func:`flash_decode_ref` - the oracle
  (``kv_append_xla`` / ``flash_decode_xla``), which the tests hold the
  plain versions against.
* Kernel K3, :func:`fused_decode_append` - in-place append of the new
  token (int8-quantized with a per-(token, head) scale) plus flash decode
  over s <= pos (``fused_decode_append_pallas``).
* The split route, taken when :data:`FLASH_FUSED_APPEND` is off: kernel
  K10, :func:`kv_append` - the append on its own (``kv_append_pallas``) -
  then :func:`flash_decode` - flash decode over the cached rows s <= pos
  (``flash_decode_pallas``) by the kernel that :data:`FLASH_MHA_MODE` and
  :data:`FLASH_BATCH_FOLD` select: K11 (``_decode_kernel``), K12 (the
  elementwise MHA numerics, ``_decode_kernel_ew``) or K13 (the batch
  folded into each block, ``_decode_kernel_bfold``).
* Kernel K10 over a prompt's T rows, :func:`kv_prefill_write` - the
  prefill's KV write (the JAX model's XLA ops: ``_quant_rows``, the slice
  writes, the dequantized rows the prefill attends).
* Kernel K4, :func:`flash_prefill` - causal flash attention with native
  GQA and ALiBi (``flash_prefill_pallas``), CUDA in
  ``csrc/prefill_attention.cu``.

K3 and K11-K13 are ``csrc/decode_attention.cu``, K10 ``csrc/kv_append.cu``;
the same entries serve the page pool (``ops/paged_attention.py``), with a
page table in place of the slot rule. The JAX kernels return new cache
arrays through ``input_output_aliases``; here the caches are updated IN
PLACE and the same tensors are returned.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from sleekit_tpu_torch.kernels import CudaKernel, zeroed_tickets

_INT8_MAX = 127.0
_SCALE_FLOOR = 1e-8

# Fuse the KV append INTO the flash-decode kernel (K3, one launch per
# layer); False takes the split route, K10 then K11 (K14 then K15 over a
# page pool). Read at each call, as are the knobs below; each has the name
# and default of the JAX package's knob. The JAX package's TPU schedule
# knobs (FLASH_FOLD, FLASH_KV_CHUNK) have no counterpart: the CUDA kernels
# keep one schedule.
FLASH_FUSED_APPEND = True

# The split route's flash decode: 'ew' at G = 1 takes K12 (f32
# elementwise numerics), 'dot' K11; K12 wins over the batch fold.
FLASH_MHA_MODE = "dot"

# Fold the batch into each flash-decode block (K13); K11's answer, bit for
# bit.
FLASH_BATCH_FOLD = False

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k_new, v_new, cache_k, cache_v, k_scale, v_scale, slopes, pos, table,
#  out, part, tickets, pos_scalar, layer, B, KV, G, P, PS, MAXP, D, R,
#  splits, scale, q_bf16, cache_kind, scale_bf16)
FUSED_DECODE_ARGS = [_P] * 13 + [_I] * 11 + [_F] + [_I] * 3
# The same without k_new and v_new.
FLASH_DECODE_ARGS = [_P] * 11 + [_I] * 11 + [_F] + [_I] * 3
_LL = ctypes.c_longlong
# (k, v, cache_k, cache_v, k_scale, v_scale, out_k, out_v, pos, table, sb,
#  st, sh, pos_scalar, layer, B, T, KV, P, PS, MAXP, D, vec, in_bf16,
#  cache_kind, scale_bf16)
KV_APPEND_ARGS = [_P] * 10 + [_LL] * 3 + [_I] * 13
K3 = CudaKernel(
    "K3", "decode_attention.cu", "fused_decode_append", FUSED_DECODE_ARGS,
    replaces="sleekit_tpu/ops/attention.py:704 fused_decode_append_pallas")
K10 = CudaKernel(
    "K10", "kv_append.cu", "kv_append", KV_APPEND_ARGS,
    replaces="sleekit_tpu/ops/attention.py:189 kv_append_pallas")
K11 = CudaKernel(
    "K11", "decode_attention.cu", "flash_decode", FLASH_DECODE_ARGS,
    replaces="sleekit_tpu/ops/attention.py:903 flash_decode_pallas")
K12 = CudaKernel(
    "K12", "decode_attention.cu", "flash_decode_ew", FLASH_DECODE_ARGS,
    replaces="sleekit_tpu/ops/attention.py:903 flash_decode_pallas")
K13 = CudaKernel(
    "K13", "decode_attention.cu", "flash_decode_bfold", FLASH_DECODE_ARGS,
    replaces="sleekit_tpu/ops/attention.py:903 flash_decode_pallas")
# (q, k, v, slopes, out, B, T, H, KV, D, scale, is_bf16)
K4 = CudaKernel(
    "K4", "prefill_attention.cu", "flash_prefill",
    [_P] * 5 + [_I] * 5 + [_F] + [_I],
    replaces="sleekit_tpu/ops/attention.py:1138 flash_prefill_pallas")

_CACHE_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}

# The decode-attention kernels' split over the cache rows
# (``csrc/decode_attention.cu``: THREADS, MIN_ROWS, MAX_ROWS): blocks of
# DECODE_WARPS warps, a split of DECODE_MIN_ROWS to DECODE_MAX_ROWS logical
# rows, as many as DECODE_SPLIT_BYTES of K rows hold (:func:`decode_plan`).
DECODE_WARPS = 4
DECODE_MIN_ROWS = 16
DECODE_MAX_ROWS = 256
DECODE_SPLIT_BYTES = 16384


def _quant_rows(x: torch.Tensor):
    """x (..., D) f32 -> (int8 values, f32 scale (..., 1)); symmetric
    per-row scale, round half to even (as ``jnp.round``). The divisor is a
    device tensor: PyTorch's CUDA division by a Python number multiplies
    by its reciprocal, which can differ in the last bit from the division
    the reference and the kernel do."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / amax.new_full((), _INT8_MAX),
                        min=_SCALE_FLOOR)
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def _pos_vec(pos, b: int, s: int, device) -> torch.Tensor:
    """Scalar or (B,) positions -> (B,) int64, clamped to [0, S-1]."""
    p = torch.as_tensor(pos, device=device).to(torch.int64)
    return torch.clamp(torch.broadcast_to(p, (b,)), 0, s - 1)


# ---- oracle ---------------------------------------------------------------


def kv_append_ref(k_new, v_new, cache_k, cache_v, pos, layer: int,
                  k_scale=None, v_scale=None):
    """Write k_new/v_new (B, KV, D) at per-row ``pos`` of ``layer``, in
    place; int8 caches quantize first. Returns the (updated) caches."""
    L, B, KV, S, D = cache_k.shape
    p = _pos_vec(pos, B, S, cache_k.device)
    rows = torch.arange(B, device=cache_k.device)
    if k_scale is None:
        cache_k[layer, rows, :, p] = k_new.to(cache_k.dtype)
        cache_v[layer, rows, :, p] = v_new.to(cache_v.dtype)
        return cache_k, cache_v
    kq, ks = _quant_rows(k_new.float())
    vq, vs = _quant_rows(v_new.float())
    cache_k[layer, rows, :, p] = kq.to(cache_k.dtype)
    cache_v[layer, rows, :, p] = vq.to(cache_v.dtype)
    k_scale[layer, rows, :, p] = ks[..., 0].to(k_scale.dtype)
    v_scale[layer, rows, :, p] = vs[..., 0].to(v_scale.dtype)
    return cache_k, cache_v, k_scale, v_scale


def flash_decode_ref(q, cache_k, cache_v, pos, layer: int, scale,
                     alibi_slopes=None, k_scale=None, v_scale=None):
    """Masked softmax(q k^T) v over s <= pos (the oracle)."""
    L, B, KV, S, D = cache_k.shape
    H = q.shape[1]
    G = H // KV
    p = _pos_vec(pos, B, S, q.device)
    k, v = cache_k[layer], cache_v[layer]
    if k_scale is not None:
        k = k.float() * k_scale[layer].float()[..., None]
        v = v.float() * v_scale[layer].float()[..., None]
    q4 = q.reshape(B, KV, G, D)
    logits = torch.einsum("bkgd,bksd->bkgs", q4.float(), k.float()) * scale
    col = torch.arange(S, device=q.device)
    mask = col[None, :] <= p[:, None]                       # (B, S)
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(KV, G)
        dist = (col[None, :] - p[:, None]).float()
        logits = logits + slopes[None, :, :, None] * dist[:, None, None, :]
    logits = torch.where(mask[:, None, None, :], logits, -math.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v.to(q.dtype))
    return out.reshape(B, H, D).to(q.dtype)


# ---- K3: fused append + flash decode ---------------------------------------


def fused_decode_append_plain(q, k_new, v_new, cache_k, cache_v, pos,
                              layer: int, scale: float, alibi_slopes=None,
                              k_scale=None, v_scale=None):
    """Plain PyTorch version of kernel K3 (the kernel's arithmetic): cached
    rows s < pos come from the cache, the new token's logit and value from
    its own (quantized) K/V, q and K/V in the compute dtype (bf16 for bf16
    q) with f32 products, and p rounded to that dtype before p @ V."""
    L, B, KV, S, D = cache_k.shape
    H = q.shape[1]
    G = H // KV
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    p = _pos_vec(pos, B, S, q.device)
    quantized = k_scale is not None

    def rnd(t):
        return t.to(cdt).float()

    if quantized:
        kq, ksc = _quant_rows(k_new.float())
        vq, vsc = _quant_rows(v_new.float())
        # The token's scale round-trips the stored scale dtype first.
        ksc = ksc[..., 0].to(k_scale.dtype).float()            # (B, KV)
        vsc = vsc[..., 0].to(v_scale.dtype).float()
        k_tok, v_tok = kq.float(), vq.float()
    else:
        k_tok = rnd(k_new.to(cache_k.dtype))
        v_tok = rnd(v_new.to(cache_v.dtype))
    qf = rnd(q).reshape(B, KV, G, D)
    logits = torch.einsum("bkgd,bksd->bkgs", qf, rnd(cache_k[layer])) * scale
    nl = (qf * k_tok[:, :, None, :]).sum(dim=-1) * scale         # (B,KV,G)
    if quantized:
        logits = logits * k_scale[layer].float()[:, :, None, :]
        nl = nl * ksc[:, :, None]
    col = torch.arange(S, device=q.device)
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(KV, G)
        dist = (col[None, :] - p[:, None]).float()
        logits = logits + slopes[None, :, :, None] * dist[:, None, None, :]
    logits = torch.where((col[None, :] < p[:, None])[:, None, None, :],
                         logits, -math.inf)
    m = torch.maximum(logits.amax(dim=-1), nl)
    pe = torch.exp(logits - m[..., None])
    pt = torch.exp(nl - m)
    l_sum = pe.sum(dim=-1) + pt
    if quantized:
        pe = pe * v_scale[layer].float()[:, :, None, :]
        pt = pt * vsc[:, :, None]
    pv = (torch.einsum("bkgs,bksd->bkgd", rnd(pe), rnd(cache_v[layer]))
          + rnd(pt)[..., None] * v_tok[:, :, None, :])
    out = (pv / l_sum[..., None]).reshape(B, H, D).to(q.dtype)

    rows = torch.arange(B, device=q.device)
    if quantized:
        cache_k[layer, rows, :, p] = kq.to(cache_k.dtype)
        cache_v[layer, rows, :, p] = vq.to(cache_v.dtype)
        k_scale[layer, rows, :, p] = ksc.to(k_scale.dtype)
        v_scale[layer, rows, :, p] = vsc.to(v_scale.dtype)
        return out, cache_k, cache_v, k_scale, v_scale
    cache_k[layer, rows, :, p] = k_new.to(cache_k.dtype)
    cache_v[layer, rows, :, p] = v_new.to(cache_v.dtype)
    return out, cache_k, cache_v


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _pos_arg(pos, B: int, dev):
    """(pointer, scalar) of ``pos`` for a kernel: a (B,) int32 tensor on
    the device, or an int."""
    if isinstance(pos, torch.Tensor):
        _check(pos.dtype == torch.int32 and pos.shape == (B,)
               and pos.device == dev and pos.is_contiguous(),
               "tensor pos must be a contiguous (B,) int32 on q's device")
        return pos.data_ptr(), 0
    return 0, int(pos)


def _geometry(cache_k, cache_v, k_scale, v_scale, page_table, B: int, dev):
    """Checks the cache (and table) a decode kernel reads and returns
    ``(rows, cache_kind, scale_bf16, table_ptr)`` with ``rows`` =
    (P, PS, MAXP): a slot cache (L, B, KV, S, D) is the pool with P = B,
    PS = S and one page per row, addressed without a table."""
    L, P, KV, PS, D = cache_k.shape
    for t in (cache_k, cache_v):
        _check(t.is_contiguous() and t.device == dev,
               "the caches must be contiguous on q's device")
    _check(cache_k.dtype in _CACHE_KIND and cache_v.dtype == cache_k.dtype
           and cache_v.shape == cache_k.shape,
           "caches must be one int8/bf16/f32 dtype and shape")
    quantized = k_scale is not None
    _check(quantized == (cache_k.dtype == torch.int8),
           "an int8 cache needs scale planes, and only it takes them")
    scale_bf16 = 0
    if quantized:
        _check(k_scale.shape == (L, P, KV, PS)
               and v_scale.shape == k_scale.shape
               and k_scale.dtype in (torch.bfloat16, torch.float32)
               and v_scale.dtype == k_scale.dtype
               and k_scale.is_contiguous() and v_scale.is_contiguous()
               and k_scale.device == dev and v_scale.device == dev,
               "scale planes must be contiguous (L, P, KV, PS) bf16/f32 "
               "beside the cache")
        scale_bf16 = int(k_scale.dtype == torch.bfloat16)
    if page_table is None:
        _check(P == B, "a slot cache holds one row per batch row")
        return (P, PS, 1), _CACHE_KIND[cache_k.dtype], scale_bf16, 0
    # Table entries must be page ids in [0, P): checking them would cost
    # the host a copy from the device at every call, so the caller (the
    # Engine) keeps them so.
    _check(page_table.dtype == torch.int32 and page_table.ndim == 2
           and page_table.shape[0] == B and page_table.is_contiguous()
           and page_table.device == dev,
           "page_table must be a contiguous (B, MAXP) int32 on q's device")
    return ((P, PS, page_table.shape[1]), _CACHE_KIND[cache_k.dtype],
            scale_bf16, page_table.data_ptr())


def decode_lanes(D: int, itemsize: int) -> int:
    """Lanes of a warp that read one cache row of D elements of
    ``itemsize`` bytes, 16 bytes each: a power of two, at most 32 (the
    source's ``lanes_per_row``)."""
    chunks = -(-D * itemsize // 16)
    lanes = 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    return lanes


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, KV: int, G: int, D: int, itemsize: int,
                capacity: int):
    """``(R, splits, scratch_bytes)`` of a decode-attention launch over a
    cache of ``capacity`` logical rows (S for a slot cache, MAXP*PS for a
    pool) of D elements of ``itemsize`` bytes. A split is R rows, a
    multiple of ``step`` (16 and one block step's rows, DECODE_WARPS warps
    of 32 / lanes rows): as many as DECODE_SPLIT_BYTES of K rows (16-byte
    chunks) hold, at most DECODE_MAX_ROWS, at least one step. R depends on
    D and the cache dtype alone, never on B, KV, G or the row rule, so a
    split's arithmetic depends only on its logical rows. ``splits`` cover
    the capacity; the scratch holds each split's (acc[D], m, l) per query
    head in f32, (B, KV, splits, G, D + 2)."""
    step = max(DECODE_MIN_ROWS,
               DECODE_WARPS * (32 // decode_lanes(D, itemsize)))
    row_bytes = -(-D * itemsize // 16) * 16
    fit = min(DECODE_MAX_ROWS, DECODE_SPLIT_BYTES // row_bytes)
    R = max(step, fit // step * step)
    splits = -(-capacity // R)
    return R, splits, 4 * B * KV * splits * G * (D + 2)


def launch_decode(kernel: CudaKernel, q, k_new, v_new, cache_k, cache_v,
                  pos, layer: int, scale: float, alibi_slopes, k_scale,
                  v_scale, page_table=None):
    """Launches a kernel of ``csrc/decode_attention.cu`` after checking its
    arguments: the fused append + decode (K3, K5) when ``k_new`` is given,
    else flash decode (K11, K15; K12 at G = 1 and K13 over a slot cache).
    Returns out (B, H, D)."""
    B, H, D = q.shape
    L, _, KV = cache_k.shape[:3]
    dev = q.device
    _check(q.dtype in (torch.bfloat16, torch.float32) and q.is_contiguous()
           and H % KV == 0 and cache_k.shape[-1] == D,
           "q must be a contiguous (B, H, D) bf16/f32 with H % KV == 0")
    _check(D <= 256, "head_dim must be <= 256")
    if k_new is not None:
        for t in (k_new, v_new):
            _check(t.dtype == q.dtype and t.shape == (B, KV, D)
                   and t.is_contiguous() and t.device == dev,
                   "k_new/v_new must be contiguous (B, KV, D) in q's dtype "
                   "on its device")
    _check(0 <= layer < L, f"layer {layer} out of range")
    (P, PS, MAXP), kind, scale_bf16, table = _geometry(
        cache_k, cache_v, k_scale, v_scale, page_table, B, dev)
    if alibi_slopes is not None:
        _check(alibi_slopes.dtype == torch.float32
               and alibi_slopes.shape == (H,) and alibi_slopes.device == dev
               and alibi_slopes.is_contiguous(),
               "alibi_slopes must be a contiguous f32 (H,) on q's device")
    pos_ptr, pos_scalar = _pos_arg(pos, B, dev)
    R, splits, nbytes = decode_plan(B, KV, H // KV, D,
                                    cache_k.element_size(), MAXP * PS)
    # One allocation a call: out, then the partials from a 16-byte boundary
    # (as_strided: the cheapest view on the host).
    size = q.element_size()
    at = -(-B * H * D * size // 16) * 16
    buf = torch.empty((at + nbytes) // size, dtype=q.dtype, device=dev)
    out = buf.as_strided((B, H, D), (H * D, D, 1))
    ptrs = [q.data_ptr()]
    if k_new is not None:
        ptrs += [k_new.data_ptr(), v_new.data_ptr()]
    ptrs += [cache_k.data_ptr(), cache_v.data_ptr(),
             k_scale.data_ptr() if k_scale is not None else 0,
             v_scale.data_ptr() if v_scale is not None else 0,
             0 if alibi_slopes is None else alibi_slopes.data_ptr(),
             pos_ptr, table, out.data_ptr(), buf.data_ptr() + at,
             zeroed_tickets(B * KV, dev).data_ptr()]
    kernel(*ptrs, pos_scalar, layer, B, KV, H // KV, P, PS, MAXP, D, R,
           splits, float(scale), int(q.dtype == torch.bfloat16), kind,
           scale_bf16)
    return out


def append_vec(D: int, strides, ptrs) -> int:
    """Elements a lane of ``csrc/kv_append.cu`` moves at once: the most,
    up to 16 bytes of the input, that divide D and every input stride
    (``strides``, in elements) and that keep every pointer of ``ptrs``,
    ``(address, itemsize)`` pairs, aligned to its chunk (at most 16
    bytes). ``ptrs[0]`` is the input's."""
    e = 16 // ptrs[0][1]
    while e > 1 and (D % e or any(s % e for s in strides)
                     or any(p % min(16, e * size) for p, size in ptrs)):
        e //= 2
    return e


def launch_append(kernel: CudaKernel, k, v, cache_k, cache_v, pos,
                  layer: int, k_scale, v_scale, page_table=None,
                  out=None) -> None:
    """Launches ``csrc/kv_append.cu`` (K10, K14) after checking its
    arguments: the rows k/v (B, T, KV, D), of any batch, token and head
    strides and unit stride along D, written at cache rows pos + t
    (``pos`` an int or a (B,) int32 tensor, clamped to the last T rows);
    ``out`` (2, B, KV, T, D) in k's dtype, or None, takes the dequantized
    rows of an int8 cache. T > 1 takes a slot cache and an int ``pos``
    with pos + T within its rows."""
    B, T, KV, D = k.shape
    L = cache_k.shape[0]
    dev = k.device
    _check(k.dtype in (torch.bfloat16, torch.float32)
           and v.dtype == k.dtype and v.shape == k.shape
           and v.stride() == k.stride() and k.stride(3) == 1
           and k.device == v.device,
           "k and v must be (B, T, KV, D) bf16/f32 of one dtype, device and "
           "strides, with unit stride along D")
    _check(cache_k.shape[2] == KV and cache_k.shape[4] == D,
           "the cache must be (L, P, KV, PS, D) of k's KV and D")
    _check(0 <= layer < L, f"layer {layer} out of range")
    (P, PS, MAXP), kind, scale_bf16, table = _geometry(
        cache_k, cache_v, k_scale, v_scale, page_table, B, dev)
    pos_ptr, pos_scalar = _pos_arg(pos, B, dev)
    if T > 1:
        _check(page_table is None and not pos_ptr
               and 0 <= pos_scalar and pos_scalar + T <= PS,
               f"{T} rows from pos {pos_scalar} take a slot cache of at "
               f"least pos + T rows ({PS})")
    ptrs = [(k.data_ptr(), k.element_size()), (v.data_ptr(), k.element_size()),
            (cache_k.data_ptr(), cache_k.element_size()),
            (cache_v.data_ptr(), cache_k.element_size())]
    if out is not None:
        _check(kind == 0 and out.dtype == k.dtype
               and out.shape == (2, B, KV, T, D) and out.is_contiguous()
               and out.device == dev,
               "out takes an int8 cache's dequantized rows: a contiguous "
               "(2, B, KV, T, D) in k's dtype")
        ptrs.append((out.data_ptr(), k.element_size()))
    strides = k.stride()[:3]
    vec = append_vec(D, strides, ptrs)
    _check(D // vec <= 256, f"rows of {D} elements in chunks of {vec} take "
           "more than 8 chunks a lane")
    out_k = out_v = 0
    if out is not None:
        out_k, out_v = out[0].data_ptr(), out[1].data_ptr()
    kernel(k.data_ptr(), v.data_ptr(), cache_k.data_ptr(),
           cache_v.data_ptr(), k_scale.data_ptr() if k_scale is not None
           else 0, v_scale.data_ptr() if v_scale is not None else 0,
           out_k, out_v, pos_ptr, table, *strides, pos_scalar, layer, B, T,
           KV, P, PS, MAXP, D, vec, int(k.dtype == torch.bfloat16), kind,
           scale_bf16)


def _updated(cache_k, cache_v, k_scale, v_scale):
    if k_scale is None:
        return cache_k, cache_v
    return cache_k, cache_v, k_scale, v_scale


def fused_decode_append(q, k_new, v_new, cache_k, cache_v, pos, layer: int,
                        scale: float, alibi_slopes=None, k_scale=None,
                        v_scale=None):
    """Kernel K3: append k_new/v_new (B, KV, D) into the (L, B, KV, S, D)
    cache at ``pos`` (an int, or a (B,) int32 tensor on the device; clamped
    to S-1) of ``layer`` IN PLACE, and return the attention of q (B, H, D)
    over s <= pos. Returns ``(out, cache_k, cache_v[, k_scale, v_scale])``
    with the caches being the argument tensors, mutated. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return fused_decode_append_plain(q, k_new, v_new, cache_k, cache_v,
                                         pos, layer, scale, alibi_slopes,
                                         k_scale, v_scale)
    out = launch_decode(K3, q, k_new, v_new, cache_k, cache_v, pos, layer,
                        scale, alibi_slopes, k_scale, v_scale)
    return (out, *_updated(cache_k, cache_v, k_scale, v_scale))


# ---- the split route: K10 append, K11 flash decode -------------------------


# The append's arithmetic is the oracle's: quantize (int8 caches), then
# write the row; kernel K10 writes the same bytes.
kv_append_plain = kv_append_ref


def kv_append(k_new, v_new, cache_k, cache_v, pos, layer: int,
              k_scale=None, v_scale=None):
    """Kernel K10: write k_new/v_new (B, KV, D) into the (L, B, KV, S, D)
    cache at ``pos`` (an int or a (B,) int32 tensor; clamped to S-1) of
    ``layer`` IN PLACE, int8 caches quantized with a per-(token, head)
    scale. Returns the caches (the argument tensors). A CUDA tensor
    launches the kernel; a CPU tensor takes :func:`kv_append_plain`."""
    if not k_new.is_cuda:
        return kv_append_plain(k_new, v_new, cache_k, cache_v, pos, layer,
                               k_scale, v_scale)
    launch_append(K10, k_new[:, None], v_new[:, None], cache_k, cache_v,
                  pos, layer, k_scale, v_scale)
    return _updated(cache_k, cache_v, k_scale, v_scale)


def kv_prefill_write_plain(k, v, cache_k, cache_v, layer: int,
                           k_scale=None, v_scale=None):
    """Plain PyTorch version of :func:`kv_prefill_write`: the JAX model's
    prefill write at position 0 (``_quant_rows``, the slice writes, the
    scale planes, the dequantized cache rows), op by op."""
    t = k.shape[1]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)         # (B, KV, T, D)
    ck, cv = cache_k[layer], cache_v[layer]               # views
    if k_scale is None:
        ck[:, :, :t] = kt.to(ck.dtype)
        cv[:, :, :t] = vt.to(cv.dtype)
        return ck[:, :, :t], cv[:, :, :t]
    kq, ks = _quant_rows(kt.float())
    vq, vs = _quant_rows(vt.float())
    ck[:, :, :t] = kq.to(ck.dtype)
    cv[:, :, :t] = vq.to(cv.dtype)
    kscale, vscale = k_scale[layer], v_scale[layer]
    kscale[:, :, :t] = ks[..., 0].to(kscale.dtype)
    vscale[:, :, :t] = vs[..., 0].to(vscale.dtype)
    attn_k = (ck[:, :, :t].float() * kscale[:, :, :t, None].float()).to(
        k.dtype)
    attn_v = (cv[:, :, :t].float() * vscale[:, :, :t, None].float()).to(
        k.dtype)
    return attn_k, attn_v


def kv_prefill_write(k, v, cache_k, cache_v, layer: int, k_scale=None,
                     v_scale=None):
    """Kernel K10 over T rows: write a prompt's k/v (B, T, KV, D) - views
    of any batch, token and head strides, unit stride along D, such as
    slices of the fused qkv output - at rows [0, T) of ``layer`` of the
    (L, B, KV, S, D) slot cache IN PLACE, int8 caches quantized with a
    per-(token, head) scale. Returns the K/V the prefill attends, (B, KV,
    T, D): for an int8 cache the rows dequantized with the stored scales,
    in k's dtype (contiguous), else views of the cache rows. A CUDA tensor
    launches the kernel; a CPU tensor takes
    :func:`kv_prefill_write_plain`."""
    if not k.is_cuda:
        return kv_prefill_write_plain(k, v, cache_k, cache_v, layer,
                                      k_scale, v_scale)
    if k.stride() != v.stride():
        # RoPE's k is a new tensor while v is still a slice of qkv: the
        # kernel takes one set of strides.
        k, v = k.contiguous(), v.contiguous()
    B, T, KV, D = k.shape
    out = None
    if k_scale is not None:
        out = torch.empty((2, B, KV, T, D), dtype=k.dtype, device=k.device)
    launch_append(K10, k, v, cache_k, cache_v, 0, layer, k_scale, v_scale,
                  out=out)
    if out is None:
        return cache_k[layer, :, :, :T], cache_v[layer, :, :, :T]
    return out[0], out[1]


def flash_decode_plain(q, cache_k, cache_v, pos, layer: int, scale: float,
                       alibi_slopes=None, k_scale=None, v_scale=None):
    """Plain PyTorch version of kernel K11 (the kernel's arithmetic): the
    cached rows s <= pos, q and K/V in the compute dtype (bf16 for bf16 q)
    with f32 products and the key scales applied to the logits, and p
    (times the value scales) rounded to that dtype before p @ V."""
    L, B, KV, S, D = cache_k.shape
    H = q.shape[1]
    G = H // KV
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    p = _pos_vec(pos, B, S, q.device)

    def rnd(t):
        return t.to(cdt).float()

    qf = rnd(q).reshape(B, KV, G, D)
    logits = torch.einsum("bkgd,bksd->bkgs", qf, rnd(cache_k[layer])) * scale
    if k_scale is not None:
        logits = logits * k_scale[layer].float()[:, :, None, :]
    col = torch.arange(S, device=q.device)
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(KV, G)
        dist = (col[None, :] - p[:, None]).float()
        logits = logits + slopes[None, :, :, None] * dist[:, None, None, :]
    logits = torch.where((col[None, :] <= p[:, None])[:, None, None, :],
                         logits, -math.inf)
    pe = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l_sum = pe.sum(dim=-1)
    if v_scale is not None:
        pe = pe * v_scale[layer].float()[:, :, None, :]
    pv = torch.einsum("bkgs,bksd->bkgd", rnd(pe), rnd(cache_v[layer]))
    return (pv / l_sum[..., None]).reshape(B, H, D).to(q.dtype)


def flash_decode_ew_plain(q, cache_k, cache_v, pos, layer: int,
                          scale: float, alibi_slopes=None, k_scale=None,
                          v_scale=None):
    """Plain PyTorch version of kernel K12, MHA (G = 1) only: K11's
    function with everything in f32 - q and K in f32, an int8 key's scale
    applied to K before the dot, f32 logits, p not rounded and scaled by
    the value scale, an f32 p @ V - and only the output cast to q's
    dtype."""
    L, B, KV, S, D = cache_k.shape
    _check(q.shape[1] == KV, "mha_mode='ew' (K12) is MHA: H == KV")
    p = _pos_vec(pos, B, S, q.device)
    k = cache_k[layer].float()
    if k_scale is not None:
        k = k * k_scale[layer].float()[..., None]
    logits = (q.float()[:, :, None, :] * k).sum(dim=-1) * scale  # (B,KV,S)
    col = torch.arange(S, device=q.device)
    if alibi_slopes is not None:
        dist = (col[None, :] - p[:, None]).float()
        logits = logits + alibi_slopes.float()[None, :, None] * dist[:, None]
    logits = torch.where((col[None, :] <= p[:, None])[:, None, :], logits,
                         -math.inf)
    pe = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l_sum = pe.sum(dim=-1)
    if v_scale is not None:
        pe = pe * v_scale[layer].float()
    pv = (pe[..., None] * cache_v[layer].float()).sum(dim=2)    # (B, KV, D)
    return (pv / l_sum[..., None]).to(q.dtype)


def decode_route(q, cache_k, mha_mode: Optional[str] = None,
                 batch_fold: Optional[bool] = None):
    """The flash-decode kernel and its plain version for these arguments
    and the knobs, with the JAX package's precedence: ``mha_mode`` (default
    :data:`FLASH_MHA_MODE`) 'ew' takes K12 at G = 1 only, and wins over
    ``batch_fold`` (default :data:`FLASH_BATCH_FOLD`), which takes K13;
    otherwise K11. K13 folds the batch into each block and computes K11's
    answer, so its plain version is K11's."""
    mode = mha_mode or FLASH_MHA_MODE
    if q.shape[1] == cache_k.shape[2] and mode == "ew":
        return K12, flash_decode_ew_plain
    if batch_fold if batch_fold is not None else FLASH_BATCH_FOLD:
        return K13, flash_decode_plain
    return K11, flash_decode_plain


def flash_decode(q, cache_k, cache_v, pos, layer: int, scale: float,
                 alibi_slopes=None, k_scale=None, v_scale=None,
                 block_s: int = 256, kv_chunk: Optional[int] = None,
                 mha_mode: Optional[str] = None,
                 batch_fold: Optional[bool] = None):
    """Masked decode attention of q (B, H, D) over the cache rows s <= pos
    (inclusive; an int or a (B,) int32 tensor, clamped to S-1) of
    ``layer``, GQA (head h reads KV head h // G), ALiBi slopes (H,) f32 or
    None, int8 caches with their scale planes. Returns (B, H, D) in q's
    dtype. Kernel K11, or K12 / K13 as :func:`decode_route` selects.

    ``block_s`` and ``kv_chunk`` are the TPU kernel's block sizes; the
    CUDA kernels have their own (splits of :func:`decode_plan`'s R rows),
    so every value of them gives the same answer. A CUDA tensor launches
    the kernel; a CPU tensor takes its plain version."""
    del block_s, kv_chunk
    kernel, plain = decode_route(q, cache_k, mha_mode, batch_fold)
    if not q.is_cuda:
        return plain(q, cache_k, cache_v, pos, layer, scale, alibi_slopes,
                     k_scale, v_scale)
    return launch_decode(kernel, q, None, None, cache_k, cache_v, pos, layer,
                         scale, alibi_slopes, k_scale, v_scale)


def decode_attention(q, k_new, v_new, cache_k, cache_v, pos, layer: int,
                     scale: Optional[float] = None, alibi_slopes=None,
                     k_scale=None, v_scale=None,
                     use_kernel: Optional[bool] = None):
    """Append the new token's K/V and attend over the cache (one decode
    step of one layer). The caches are updated IN PLACE and returned:
    ``(out (B, H, D), cache_k, cache_v[, k_scale, v_scale])``.
    With :data:`FLASH_FUSED_APPEND` one kernel does both (K3), else the
    append (K10) and the flash decode (K11, or K12 / K13 as the knobs
    select, :func:`decode_route`) run in turn. ``use_kernel`` (default: q
    is on CUDA) launches the kernels, else their plain versions run."""
    if scale is None:
        scale = 1.0 / math.sqrt(cache_k.shape[-1])
    if use_kernel is None:
        use_kernel = q.is_cuda
    if FLASH_FUSED_APPEND:
        fn = fused_decode_append if use_kernel else fused_decode_append_plain
        return fn(q, k_new, v_new, cache_k, cache_v, pos, layer, scale,
                  alibi_slopes, k_scale=k_scale, v_scale=v_scale)
    append, attend = ((kv_append, flash_decode) if use_kernel
                      else (kv_append_plain, decode_route(q, cache_k)[1]))
    caches = append(k_new, v_new, cache_k, cache_v, pos, layer, k_scale,
                    v_scale)
    out = attend(q, cache_k, cache_v, pos, layer, scale, alibi_slopes,
                 k_scale, v_scale)
    return (out, *caches)


# ---- K4: causal flash prefill -----------------------------------------------


# Key rows per online-softmax step of K4 (BS in csrc/prefill_attention.cu);
# the plain version steps the same way, so p rounds to bf16 against the
# same running maxima as in the kernel.
_PREFILL_CHUNK = 64


def flash_prefill_plain(q, kT, vT, scale: float, alibi_slopes=None):
    """Plain PyTorch version of kernel K4: causal softmax(q k^T) v with
    head h reading KV head h // G, q and K/V in the compute dtype, f32
    logits, and online softmax over 64-row key chunks with p rounded to
    the compute dtype before p @ V."""
    B, T, H, D = q.shape
    KV = kT.shape[1]
    G = H // KV
    cdt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    qh = q.to(cdt).float().permute(0, 2, 1, 3)                # (B, H, T, D)
    k = kT.to(cdt).float().repeat_interleave(G, dim=1)
    v = vT.to(cdt).float().repeat_interleave(G, dim=1)
    row = torch.arange(T, device=q.device)[:, None]
    m = torch.full((B, H, T, 1), -math.inf, device=q.device)
    l_sum = torch.zeros((B, H, T, 1), device=q.device)
    acc = torch.zeros((B, H, T, D), device=q.device)
    for c0 in range(0, T, _PREFILL_CHUNK):
        c1 = min(c0 + _PREFILL_CHUNK, T)
        logits = qh @ k[:, :, c0:c1].transpose(-1, -2) * scale
        col = torch.arange(c0, c1, device=q.device)[None, :]
        if alibi_slopes is not None:
            logits = logits + (alibi_slopes.float()[None, :, None, None]
                               * (col - row).float())
        logits = torch.where(col <= row, logits, -math.inf)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l_sum = l_sum * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(cdt).float() @ v[:, :, c0:c1]
        m = m_new
    return (acc / l_sum).to(q.dtype).permute(0, 2, 1, 3)


def flash_prefill(q, kT, vT, scale: float, alibi_slopes=None):
    """Kernel K4: causal self-attention for prefill. q (B, T, H, D); kT/vT
    (B, KV, T, D) read in place (no GQA repeat); ALiBi slopes (H,) f32 or
    None. Returns (B, T, H, D) in q's dtype. A CUDA tensor launches the
    kernel - bf16 on the tensor cores (D % 16 == 0, D <= 128), f32 as
    split TF32 on the tensor cores, held to f32 accuracy (D % 4 == 0, D <=
    128) - or raises; a CPU tensor takes :func:`flash_prefill_plain`."""
    if not q.is_cuda:
        return flash_prefill_plain(q, kT, vT, scale, alibi_slopes)
    B, T, H, D = q.shape
    KV = kT.shape[1]
    dev = q.device
    _check(q.dtype in (torch.bfloat16, torch.float32),
           "q must be bf16 or f32")
    _check(kT.shape == (B, KV, T, D) and vT.shape == kT.shape
           and H % KV == 0, "kT/vT must be (B, KV, T, D) with H % KV == 0")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check(D <= 128 and D % 16 == 0,
               f"bf16 K4 runs on the tensor cores and takes a head_dim that "
               f"is a multiple of 16 and <= 128, not {D}")
    else:
        _check(D <= 128 and D % 4 == 0,
               f"f32 K4 takes a head_dim that is a multiple of 4 and <= 128, "
               f"not {D}")
    for t in (q, kT, vT):
        _check(t.dtype == q.dtype and t.is_contiguous() and t.device == dev,
               "q, kT and vT must be contiguous, of one dtype and device")
        _check(t.data_ptr() % 16 == 0,
               "q, kT and vT must start on a 16-byte boundary")
    if alibi_slopes is not None:
        _check(alibi_slopes.dtype == torch.float32
               and alibi_slopes.shape == (H,) and alibi_slopes.device == dev
               and alibi_slopes.is_contiguous(),
               "alibi_slopes must be a contiguous f32 (H,) on q's device")
    out = torch.empty_like(q)
    K4(q.data_ptr(), kT.data_ptr(), vT.data_ptr(),
       0 if alibi_slopes is None else alibi_slopes.data_ptr(),
       out.data_ptr(), B, T, H, KV, D, float(scale), int(bf16))
    return out
