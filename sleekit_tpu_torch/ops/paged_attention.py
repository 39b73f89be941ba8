"""Paged KV cache attention (port of ``sleekit_tpu/ops/paged_attention.py``).

KV lives in a shared page pool (L, P, KV, PS, D), with int8 scale planes
(L, P, KV, PS), and each sequence owns a list of pages through a page
table (B, MAXP) int32: logical row s of batch row b is row s % PS of
physical page table[b, s / PS]. Memory then scales with the tokens that
are resident, not with max_seq_len per slot. Table entries past a row's
last page must hold a valid page id (0, the trash page, is fine): the
kernels never read them, and the plain versions mask what they gather.

* :func:`paged_kv_append_ref` / :func:`paged_flash_decode_ref` - the
  oracle (``paged_kv_append_xla`` / ``paged_flash_decode_xla``).
* Kernel K5, :func:`paged_fused_decode_append` - kernel K3 through the
  page table (``paged_fused_decode_append_pallas``).
* Kernels K14, :func:`paged_kv_append`, and K15,
  :func:`paged_flash_decode` - the split route, K10 and K11 through the
  page table (``paged_kv_append_pallas`` / ``paged_flash_decode_pallas``).

The kernels are the slot path's CUDA entries (``csrc/decode_attention.cu``,
``csrc/kv_append.cu``) given the table, so the pool is updated IN PLACE and
the same tensors are returned.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sleekit_tpu_torch.kernels import CudaKernel
from sleekit_tpu_torch.ops import attention as _attn
from sleekit_tpu_torch.ops.attention import (
    FLASH_DECODE_ARGS, FUSED_DECODE_ARGS, KV_APPEND_ARGS, _quant_rows,
    _updated, flash_decode_plain, flash_decode_ref, fused_decode_append_plain,
    launch_append, launch_decode)

K5 = CudaKernel(
    "K5", "decode_attention.cu", "fused_decode_append", FUSED_DECODE_ARGS,
    replaces="sleekit_tpu/ops/paged_attention.py:230 "
             "paged_fused_decode_append_pallas")
K14 = CudaKernel(
    "K14", "kv_append.cu", "kv_append", KV_APPEND_ARGS,
    replaces="sleekit_tpu/ops/paged_attention.py:45 paged_kv_append_pallas")
K15 = CudaKernel(
    "K15", "decode_attention.cu", "flash_decode", FLASH_DECODE_ARGS,
    replaces="sleekit_tpu/ops/paged_attention.py:131 "
             "paged_flash_decode_pallas")


def _gathered(pool, page_table, layer: int):
    """(L, P, KV, PS[, D]) + (B, MAXP) -> (B, KV, MAXP*PS[, D]): the
    logical rows of every batch row, copied out of ``layer``."""
    g = pool[layer][page_table.long()]           # (B, MAXP, KV, PS[, D])
    B, MAXP, KV, PS = g.shape[:4]
    return g.transpose(1, 2).reshape(B, KV, MAXP * PS, *g.shape[4:])


def _gathered_cache(pool_k, pool_v, page_table, layer, k_scale, v_scale):
    """The slot-cache view (1, B, KV, MAXP*PS, D) of one layer of the pool,
    with its scale planes (or None)."""
    def one(t):
        return None if t is None else _gathered(t, page_table, layer)[None]
    return one(pool_k), one(pool_v), one(k_scale), one(v_scale)


# ---- oracle ---------------------------------------------------------------


def paged_kv_append_ref(k_new, v_new, pool_k, pool_v, page_table, pos,
                        layer: int, k_scale=None, v_scale=None):
    """Write k_new/v_new (B, KV, D) at logical ``pos`` (clamped to
    MAXP*PS - 1) of ``layer``, through the page table, in place; int8
    pools quantize first. Returns the (updated) pool."""
    PS = pool_k.shape[3]
    B = k_new.shape[0]
    p = _attn._pos_vec(pos, B, page_table.shape[1] * PS, pool_k.device)
    page = page_table.long()[torch.arange(B, device=pool_k.device), p // PS]
    row = p % PS
    if k_scale is None:
        pool_k[layer, page, :, row] = k_new.to(pool_k.dtype)
        pool_v[layer, page, :, row] = v_new.to(pool_v.dtype)
        return pool_k, pool_v
    kq, ks = _quant_rows(k_new.float())
    vq, vs = _quant_rows(v_new.float())
    pool_k[layer, page, :, row] = kq.to(pool_k.dtype)
    pool_v[layer, page, :, row] = vq.to(pool_v.dtype)
    k_scale[layer, page, :, row] = ks[..., 0].to(k_scale.dtype)
    v_scale[layer, page, :, row] = vs[..., 0].to(v_scale.dtype)
    return pool_k, pool_v, k_scale, v_scale


def paged_flash_decode_ref(q, pool_k, pool_v, page_table, pos, layer: int,
                           scale, alibi_slopes=None, k_scale=None,
                           v_scale=None):
    """Masked softmax(q k^T) v over the logical rows s <= pos (the
    oracle)."""
    k, v, ks, vs = _gathered_cache(pool_k, pool_v, page_table, layer,
                                   k_scale, v_scale)
    return flash_decode_ref(q, k, v, pos, 0, scale, alibi_slopes, ks, vs)


# ---- K14 and K15: the split route -----------------------------------------


# The append's arithmetic is the oracle's (kernel K14 writes its bytes).
paged_kv_append_plain = paged_kv_append_ref


def paged_kv_append(k_new, v_new, pool_k, pool_v, page_table, pos,
                    layer: int, k_scale=None, v_scale=None):
    """Kernel K14: :func:`~sleekit_tpu_torch.ops.attention.kv_append`
    through the page table: the row at logical ``pos`` (an int or a (B,)
    int32 tensor, clamped to MAXP*PS - 1) of batch row b is row pos % PS
    of page ``page_table[b, pos // PS]``; the scale planes are addressed
    the same way. Updates the pool IN PLACE and returns it. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    if not k_new.is_cuda:
        return paged_kv_append_plain(k_new, v_new, pool_k, pool_v,
                                     page_table, pos, layer, k_scale,
                                     v_scale)
    launch_append(K14, k_new, v_new, pool_k, pool_v, pos, layer, k_scale,
                  v_scale, page_table)
    return _updated(pool_k, pool_v, k_scale, v_scale)


def paged_flash_decode_plain(q, pool_k, pool_v, page_table, pos,
                             layer: int, scale: float, alibi_slopes=None,
                             k_scale=None, v_scale=None):
    """Plain PyTorch version of kernel K15: the pool gathered through the
    table, then kernel K11's arithmetic."""
    k, v, ks, vs = _gathered_cache(pool_k, pool_v, page_table, layer,
                                   k_scale, v_scale)
    return flash_decode_plain(q, k, v, pos, 0, scale, alibi_slopes, ks, vs)


def paged_flash_decode(q, pool_k, pool_v, page_table, pos, layer: int,
                       scale: float, alibi_slopes=None, k_scale=None,
                       v_scale=None):
    """Kernel K15: :func:`~sleekit_tpu_torch.ops.attention.flash_decode`
    (rows s <= pos, inclusive) over the page pool through the table.
    Returns (B, H, D) in q's dtype. A CUDA tensor launches the kernel; a
    CPU tensor takes :func:`paged_flash_decode_plain`."""
    if not q.is_cuda:
        return paged_flash_decode_plain(q, pool_k, pool_v, page_table, pos,
                                        layer, scale, alibi_slopes, k_scale,
                                        v_scale)
    return launch_decode(K15, q, None, None, pool_k, pool_v, pos, layer,
                         scale, alibi_slopes, k_scale, v_scale, page_table)


# ---- K5: fused append + flash decode over the pool --------------------------


def paged_fused_decode_append_plain(q, k_new, v_new, pool_k, pool_v,
                                    page_table, pos, layer: int,
                                    scale: float, alibi_slopes=None,
                                    k_scale=None, v_scale=None,
                                    page_fold: Optional[int] = None):
    """Plain PyTorch version of kernel K5: kernel K3's arithmetic over the
    pool gathered through the table, and the token written through it."""
    del page_fold
    k, v, ks, vs = _gathered_cache(pool_k, pool_v, page_table, layer,
                                   k_scale, v_scale)
    out = fused_decode_append_plain(q, k_new, v_new, k, v, pos, 0, scale,
                                    alibi_slopes, ks, vs)[0]
    return (out, *paged_kv_append_plain(k_new, v_new, pool_k, pool_v,
                                        page_table, pos, layer, k_scale,
                                        v_scale))


def paged_fused_decode_append(q, k_new, v_new, pool_k, pool_v, page_table,
                              pos, layer: int, scale: float,
                              alibi_slopes=None, k_scale=None, v_scale=None,
                              page_fold: Optional[int] = None):
    """Kernel K5: one decode step of one layer over the page pool - append
    k_new/v_new (B, KV, D) at logical ``pos`` (an int or a (B,) int32
    tensor, clamped to MAXP*PS - 1) through the table IN PLACE and return
    ``(out (B, H, D), pool_k, pool_v[, k_scale, v_scale])``, out being the
    attention over s <= pos. The kernel is K3's over the table's row rule,
    so its output and written bytes equal K3's on the same logical rows.

    ``page_fold`` is the TPU kernel's pages per program (``PAGED_FOLD``),
    a schedule: the CUDA kernel walks 128-row logical chunks whatever the
    page size, so it accepts any value and ignores it. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return paged_fused_decode_append_plain(
            q, k_new, v_new, pool_k, pool_v, page_table, pos, layer, scale,
            alibi_slopes, k_scale, v_scale)
    out = launch_decode(K5, q, k_new, v_new, pool_k, pool_v, pos, layer,
                        scale, alibi_slopes, k_scale, v_scale, page_table)
    return (out, *_updated(pool_k, pool_v, k_scale, v_scale))


def paged_decode_attention(q, k_new, v_new, pool_k, pool_v, page_table, pos,
                           layer: int, scale: Optional[float] = None,
                           alibi_slopes=None, k_scale=None, v_scale=None,
                           use_kernel: Optional[bool] = None):
    """Paged counterpart of
    :func:`~sleekit_tpu_torch.ops.attention.decode_attention`, with the
    same ``FLASH_FUSED_APPEND`` dispatch: K5, or K14 then K15. Returns
    ``(out, pool_k, pool_v[, k_scale, v_scale])``, the pool updated in
    place."""
    if scale is None:
        scale = 1.0 / math.sqrt(pool_k.shape[-1])
    if use_kernel is None:
        use_kernel = q.is_cuda
    if _attn.FLASH_FUSED_APPEND:
        fn = (paged_fused_decode_append if use_kernel
              else paged_fused_decode_append_plain)
        return fn(q, k_new, v_new, pool_k, pool_v, page_table, pos, layer,
                  scale, alibi_slopes, k_scale, v_scale)
    append, attend = ((paged_kv_append, paged_flash_decode) if use_kernel
                      else (paged_kv_append_plain, paged_flash_decode_plain))
    pool = append(k_new, v_new, pool_k, pool_v, page_table, pos, layer,
                  k_scale, v_scale)
    out = attend(q, pool_k, pool_v, page_table, pos, layer, scale,
                 alibi_slopes, k_scale, v_scale)
    return (out, *pool)
