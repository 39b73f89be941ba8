"""Decode and prefill attention (port of ``sleekit_tpu/ops/attention.py``).

The KV cache is (L, B, KV, S, D) with int8 scale planes (L, B, KV, S);
kernels take a layer index, so no per-layer slice is ever copied.

* :func:`kv_append_ref` / :func:`flash_decode_ref` - the oracle
  (``kv_append_xla`` / ``flash_decode_xla``), which the tests hold the
  plain versions against.
* Kernel K3, :func:`fused_decode_append` - in-place append of the new
  token (int8-quantized with a per-(token, head) scale) plus flash decode
  over s <= pos (``fused_decode_append_pallas``), CUDA in
  ``csrc/decode_attention.cu``.
* Kernel K4, :func:`flash_prefill` - causal flash attention with native
  GQA and ALiBi (``flash_prefill_pallas``), CUDA in
  ``csrc/prefill_attention.cu``.

The JAX kernels return new cache arrays through ``input_output_aliases``;
here the caches are updated IN PLACE and the same tensors are returned.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from sleekit_tpu_torch.kernels import CudaKernel

_INT8_MAX = 127.0
_SCALE_FLOOR = 1e-8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k_new, v_new, cache_k, cache_v, k_scale, v_scale, slopes, pos, out,
#  pos_scalar, layer, L, B, KV, G, S, D, scale, q_bf16, cache_kind,
#  scale_bf16)
K3 = CudaKernel(
    "K3", "decode_attention.cu", "fused_decode_append",
    [_P] * 10 + [_I] * 8 + [_F] + [_I] * 3,
    replaces="sleekit_tpu/ops/attention.py:704 fused_decode_append_pallas")
# (q, k, v, slopes, out, B, T, H, KV, D, scale, is_bf16)
K4 = CudaKernel(
    "K4", "prefill_attention.cu", "flash_prefill",
    [_P] * 5 + [_I] * 5 + [_F] + [_I],
    replaces="sleekit_tpu/ops/attention.py:1138 flash_prefill_pallas")

_CACHE_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


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
    L, B, KV, S, D = cache_k.shape
    H = q.shape[1]
    dev = q.device
    _check(q.dtype in (torch.bfloat16, torch.float32) and q.shape == (B, H, D)
           and H % KV == 0, "q must be (B, H, D) bf16/f32 with H % KV == 0")
    _check(D <= 256, "head_dim must be <= 256")
    for t in (q, k_new, v_new, cache_k, cache_v):
        _check(t.is_contiguous() and t.device == dev,
               "q, k_new, v_new and the caches must be contiguous on one "
               "device")
    for t in (k_new, v_new):
        _check(t.dtype == q.dtype and t.shape == (B, KV, D),
               "k_new/v_new must be (B, KV, D) in q's dtype")
    _check(cache_k.dtype in _CACHE_KIND and cache_v.dtype == cache_k.dtype
           and cache_v.shape == cache_k.shape,
           "caches must be one int8/bf16/f32 dtype and shape")
    _check(0 <= layer < L, f"layer {layer} out of range")
    quantized = k_scale is not None
    _check(quantized == (cache_k.dtype == torch.int8),
           "an int8 cache needs scale planes, and only it takes them")
    scale_bf16 = 0
    if quantized:
        _check(k_scale.shape == (L, B, KV, S) and v_scale.shape == k_scale.shape
               and k_scale.dtype in (torch.bfloat16, torch.float32)
               and v_scale.dtype == k_scale.dtype
               and k_scale.is_contiguous() and v_scale.is_contiguous()
               and k_scale.device == dev and v_scale.device == dev,
               "scale planes must be contiguous (L, B, KV, S) bf16/f32")
        scale_bf16 = int(k_scale.dtype == torch.bfloat16)
    if alibi_slopes is not None:
        _check(alibi_slopes.dtype == torch.float32
               and alibi_slopes.shape == (H,) and alibi_slopes.device == dev
               and alibi_slopes.is_contiguous(),
               "alibi_slopes must be a contiguous f32 (H,) on q's device")
    pos_ptr, pos_scalar = 0, 0
    if isinstance(pos, torch.Tensor):
        _check(pos.dtype == torch.int32 and pos.shape == (B,)
               and pos.device == dev and pos.is_contiguous(),
               "tensor pos must be a contiguous (B,) int32 on q's device")
        pos_ptr = pos.data_ptr()
    else:
        pos_scalar = int(pos)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    K3(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(),
       cache_v.data_ptr(), k_scale.data_ptr() if quantized else 0,
       v_scale.data_ptr() if quantized else 0,
       0 if alibi_slopes is None else alibi_slopes.data_ptr(), pos_ptr,
       out.data_ptr(), pos_scalar, layer, L, B, KV, H // KV, S, D,
       float(scale), int(q.dtype == torch.bfloat16),
       _CACHE_KIND[cache_k.dtype], scale_bf16)
    if quantized:
        return out, cache_k, cache_v, k_scale, v_scale
    return out, cache_k, cache_v


def decode_attention(q, k_new, v_new, cache_k, cache_v, pos, layer: int,
                     scale: Optional[float] = None, alibi_slopes=None,
                     k_scale=None, v_scale=None,
                     use_kernel: Optional[bool] = None):
    """Append the new token's K/V and attend over the cache (one decode
    step of one layer). The caches are updated IN PLACE and returned:
    ``(out (B, H, D), cache_k, cache_v[, k_scale, v_scale])``.
    ``use_kernel`` (default: q is on CUDA) launches K3, else its plain
    version runs."""
    if scale is None:
        scale = 1.0 / math.sqrt(cache_k.shape[-1])
    if use_kernel is None:
        use_kernel = q.is_cuda
    fn = fused_decode_append if use_kernel else fused_decode_append_plain
    return fn(q, k_new, v_new, cache_k, cache_v, pos, layer, scale,
              alibi_slopes, k_scale=k_scale, v_scale=v_scale)


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
    kernel; a CPU tensor takes :func:`flash_prefill_plain`."""
    if not q.is_cuda:
        return flash_prefill_plain(q, kT, vT, scale, alibi_slopes)
    B, T, H, D = q.shape
    KV = kT.shape[1]
    dev = q.device
    _check(q.dtype in (torch.bfloat16, torch.float32),
           "q must be bf16 or f32")
    _check(kT.shape == (B, KV, T, D) and vT.shape == kT.shape
           and H % KV == 0, "kT/vT must be (B, KV, T, D) with H % KV == 0")
    _check(D <= 128 and D % 4 == 0,
           "head_dim must be a multiple of 4 and <= 128")
    for t in (q, kT, vT):
        _check(t.dtype == q.dtype and t.is_contiguous() and t.device == dev,
               "q, kT and vT must be contiguous, of one dtype and device")
    if alibi_slopes is not None:
        _check(alibi_slopes.dtype == torch.float32
               and alibi_slopes.shape == (H,) and alibi_slopes.device == dev
               and alibi_slopes.is_contiguous(),
               "alibi_slopes must be a contiguous f32 (H,) on q's device")
    out = torch.empty_like(q)
    K4(q.data_ptr(), kT.data_ptr(), vT.data_ptr(),
       0 if alibi_slopes is None else alibi_slopes.data_ptr(),
       out.data_ptr(), B, T, H, KV, D, float(scale),
       int(q.dtype == torch.bfloat16))
    return out
