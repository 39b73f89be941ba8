"""Fused dequantize + matmul (port of ``sleekit_tpu/ops/dequant_matmul.py``).

``y = [residual +] pre(x) @ (lut[unpack(W)] * scale) + bias``, with the
packed words streamed from device memory and decoded on chip.

* :func:`dequant_matmul_ref` - unpack + dense f32 product, the oracle
  (``dequant_matmul_xla``).
* Kernel K1, :func:`pair_matmul` - the 'pair' layout
  (``_pallas_pair_impl``/``_pair_kernel``), CUDA in
  ``csrc/dequant_matmul.cu``.
* Kernel K2, :func:`int8_matmul` - the 'int8' layout
  (``_pallas_int8_impl``), same source.

Both kernels fuse the prologue (layernorm/rmsnorm masked to the valid K,
relu, gelu, silu_glu) and the epilogue ``(a*acc + b*rowsum)*scale + bias
[+ residual]``. Their plain versions (:func:`pair_matmul_plain`,
:func:`int8_matmul_plain`) repeat the kernels' own arithmetic: ``pre(x)``
in f32 rounded to bf16, ``rowsum`` over that bf16 ``pre(x)``, f32
accumulation. K1 decodes ``C = 1 + idx/2^nbits`` (exact in bf16) as the
TPU kernel does, but accumulates over ``C - 1.5`` and folds ``b + 1.5a``
into the rowsum term: over C itself the fold cancels catastrophically
when x has a large mean (after relu), and its f32 rounding flips about
one bf16 output in ten. The int8 layout is centred already.

The JAX package chunks prefill-size M through its kernel
(``PREFILL_CHUNK_M``, a TPU VMEM limit); the CUDA kernels tile M
themselves, so the port has no chunking.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from sleekit_tpu_torch.kernels import CudaKernel
from sleekit_tpu_torch.ops.pack import PackedLinear, unpack_indices

_PRE = {None: 0, "layernorm": 1, "rmsnorm": 2, "relu": 3, "gelu": 4,
        "silu_glu": 5}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (x, words, scale, bias, ln_scale, ln_bias, ln_bf16, residual, out,
#  M, N, K, x_cols, kw, nbits, pre, a, b, eps)
K1 = CudaKernel(
    "K1", "dequant_matmul.cu", "pair_matmul",
    [_P] * 6 + [_I] + [_P] * 2 + [_I] * 7 + [_F] * 3,
    replaces="sleekit_tpu/ops/dequant_matmul.py:515 _pallas_pair_impl")
# (x, w8, scale, bias, ln_scale, ln_bias, ln_bf16, residual, out,
#  M, N_out, K, Kp, Np, pre, a, b, eps)
K2 = CudaKernel(
    "K2", "dequant_matmul.cu", "int8_matmul",
    [_P] * 6 + [_I] + [_P] * 2 + [_I] * 6 + [_F] * 3,
    replaces="sleekit_tpu/ops/dequant_matmul.py:664 _pallas_int8_impl")


def dequant_matmul_ref(x: torch.Tensor, w: PackedLinear) -> torch.Tensor:
    """Correctness oracle: dense f32 dequantized weight, f32 product."""
    y = x.float() @ w.dequantize()
    if w.bias is not None:
        y = y + w.bias[None, :]
    return y.to(x.dtype)


def _int8_affine(w: PackedLinear):
    """(a, b) of the signed-int8 fold: deq = (a*v + b)*scale, v = idx-128."""
    step, zero = w.affine
    return step, zero + 128.0 * step


def _pair_affine(w: PackedLinear):
    """(a, b) of out = (a*acc + b*rowsum)*scale + bias for 'pair', where
    acc = x @ C and C = 1 + idx/2^nbits."""
    step, zero = w.affine
    a = step * float(2 ** w.nbits)
    return a, zero - a


def _centred(a_aff: float, b_aff: float) -> float:
    """The rowsum coefficient when acc = x @ (C - 1.5), in double, once
    rounded to f32 by the caller (b + 1.5a is small: zero + step/2)."""
    return b_aff + 1.5 * a_aff


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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(x, k, scale, bias, pre, ln_scale, ln_bias, residual, n):
    dev = x.device
    _check(x.dtype == torch.bfloat16 and x.dim() == 2 and x.is_contiguous(),
           "x must be a contiguous 2-D bf16 tensor")
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
    K1(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
       _ptr(ln_scale), _ptr(ln_bias), ln_bf16, _ptr(residual),
       out.data_ptr(), m, n, k, x.shape[1], kw, nbits, _PRE[pre],
       float(a_aff), _centred(a_aff, b_aff), float(eps))
    return out


def int8_matmul(x, packed, scale, bias, *, k, out_n, a_aff, b_aff,
                pre=None, ln_scale=None, ln_bias=None, eps=1e-5,
                residual=None):
    """Kernel K2: the K1 epilogue over pre-padded signed int8 (Kp, Np)
    weights, output sliced to ``out_n`` columns. A CUDA tensor launches the
    kernel; a CPU tensor takes :func:`int8_matmul_plain`."""
    if not x.is_cuda:
        return int8_matmul_plain(
            x, packed, scale, bias, k=k, out_n=out_n, a_aff=a_aff,
            b_aff=b_aff, pre=pre, ln_scale=ln_scale, ln_bias=ln_bias,
            eps=eps, residual=residual)
    kp, np_ = packed.shape
    _check(pre != "silu_glu", "GLU fusion is pair-layout only")
    _check(packed.dtype == torch.int8 and packed.is_contiguous()
           and packed.device == x.device,
           "packed must be contiguous int8 on x's device")
    _check(kp >= k and out_n <= np_ and np_ % 4 == 0,
           f"int8 weights {tuple(packed.shape)} do not cover K={k}, "
           f"N={out_n}")
    ln_bf16 = _check_common(x, k, scale, bias, pre, ln_scale, ln_bias,
                            residual, out_n)
    m = x.shape[0]
    out = torch.empty((m, out_n), dtype=torch.bfloat16, device=x.device)
    K2(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), _ptr(bias),
       _ptr(ln_scale), _ptr(ln_bias), ln_bf16, _ptr(residual),
       out.data_ptr(), m, out_n, k, kp, np_, _PRE[pre],
       float(a_aff), float(b_aff), float(eps))
    return out


# ---- dispatch -------------------------------------------------------------


def can_fuse_glue(x: torch.Tensor, w: PackedLinear) -> bool:
    """Whether K1/K2 take this matmul (and so its prologue/residual
    fusion): bf16 activations (f32 keeps full precision on the reference
    path, as in the JAX package), an affine codebook, and the pair
    (<= 7 bits) or int8 layout."""
    ok_pair = w.layout == "pair" and w.nbits <= 7
    ok_int8 = w.layout == "int8" and w.nbits == 8
    return ((ok_pair or ok_int8) and w.affine is not None
            and x.dtype == torch.bfloat16 and w.k_splits == 1)


def _kernel_matmul(x, w, use_kernel, pre=None, ln_scale=None, ln_bias=None,
                   eps=1e-5, residual=None):
    """K1/K2 (``use_kernel``) or their plain versions."""
    kw = dict(pre=pre, ln_scale=ln_scale, ln_bias=ln_bias, eps=eps,
              residual=residual)
    if w.layout == "int8":
        a, b = _int8_affine(w)
        fn = int8_matmul if use_kernel else int8_matmul_plain
        return fn(x, w.packed, w.scale, w.bias, k=w.in_features,
                  out_n=w.out_features, a_aff=a, b_aff=b, **kw)
    a, b = _pair_affine(w)
    fn = pair_matmul if use_kernel else pair_matmul_plain
    return fn(x, w.packed, w.scale, w.bias, nbits=w.nbits, k=w.in_features,
              a_aff=a, b_aff=b, **kw)


def quantized_matmul(x: torch.Tensor, w: PackedLinear,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """y = x @ deq(w) + bias. Matmuls K1/K2 take run the kernel when
    ``use_kernel`` (default: x is on CUDA), else its plain version; the
    rest run the reference."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if can_fuse_glue(x, w):
        return _kernel_matmul(x.contiguous(), w, use_kernel)
    return dequant_matmul_ref(x, w)


def fused_quantized_matmul(x: torch.Tensor, w: PackedLinear, *,
                           pre: Optional[str] = None,
                           ln_scale: Optional[torch.Tensor] = None,
                           ln_bias: Optional[torch.Tensor] = None,
                           eps: float = 1e-5,
                           residual: Optional[torch.Tensor] = None,
                           use_kernel: Optional[bool] = None
                           ) -> torch.Tensor:
    """``y = [residual +] pre(x) @ deq(w) + bias``: one K1/K2 launch (or
    its plain version, see :func:`quantized_matmul`) where the kernels
    take the matmul; otherwise the same math composed from PyTorch ops
    (the oracle)."""
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
