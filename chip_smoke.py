"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels (K1-K11, K14, K15) from
   ``sleekit_tpu_torch/csrc``, one nvcc per source, all at once;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes OPT-1.3B serving gives it, and times the kernel, the plain
   version and, where one exists, one PyTorch library call computing the
   same function (a yardstick the port never calls) with CUDA events. The
   page-pool kernels (K5, K14, K15) run over a strided, out-of-order table
   of distinct 64-row pages; K5 is held bit for bit to K3 on the same
   logical rows;
3. serves 8 greedy requests of 32 new tokens through the port's slot
   Engine with OPT-1.3B at full width and depth (random int4 'pair'
   weights from a seed, fused q|k|v, int8 head, int8 KV cache with bf16
   scales), checks that every kernel launched and the launches of one
   decode step, checks the prefill logits against the kernels' plain
   versions on the card (bf16 tolerance through the first layer, relative
   L2 through all of them), and times batch-8 decode;
4. serves the same requests through the paged Engine (page pool of 64-row
   pages): run A on the default pool emits the slot Engine's tokens and
   launches 96 K1, 1 K2 and 24 K5 (no K3) per decode step; run B on a
   17-page pool blocks admission and recycles pages; decode through a
   pool holding the slot cache's rows gives the slot cache's logits, bit
   for bit, and is timed as in 3;
5. takes one decode step on the split route (FLASH_FUSED_APPEND off) over
   the slot cache (24 K10 + 24 K11) and over the pool (24 K14 + 24 K15),
   within the bf16 tolerance of the fused route's logits;
6. holds K6 ('pair3x'), K7 ('pair3'), K8 (NF4 'plane') and K9 (uniform
   int4 'plane') against their plain versions on the four projections of
   an OPT-1.3B layer at M = 8 and M = 1024, timed as in 2;
7. serves the same 8 prompts through the slot Engine with the int3
   'pair3x' model, the same indices repacked as 'pair3', and an NF4
   'plane' model, all at full width and depth (16 new tokens each): one
   decode step launches exactly 96 K6, K7 or K8, 1 K2 and 24 K3 (no K1);
   prefill logits, kernels vs plain versions, as in 3 (NF4's random model
   drifts: its full depth is measured, and held on the same indices over
   its table minus its mean), and each of the 24 layers on the same input
   within the bf16 tolerance; the pair3
   logits against the pair3x ones; batch-8 decode timed as in 3. Then
   repacks the int4 model's indices as 'plane' (uniform codebook): its
   prefill logits against the 'pair' model's, its layers one by one, and
   decode steps with 96 K9 each;
8. prints the kernels line, the card's name and power limit, and, last,
   the result line.

Any failure raises; there is no CPU branch and no fallback. It needs a
CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sleekit_tpu_torch import kernels  # noqa: E402
from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook  # noqa: E402
from sleekit_tpu_torch.models.eval import decode_scan  # noqa: E402
from sleekit_tpu_torch.models.fake_quant import random_packed_params  # noqa: E402
from sleekit_tpu_torch.models.quantize import pack_lm_head  # noqa: E402
from sleekit_tpu_torch.models import transformer as tr  # noqa: E402
from sleekit_tpu_torch.models.transformer import (  # noqa: E402
    decode_step, init_kv_cache, prefill)
from sleekit_tpu_torch.models.zoo import opt_1b3  # noqa: E402
from sleekit_tpu_torch.ops import attention as attn  # noqa: E402
from sleekit_tpu_torch.ops import dequant_matmul as dm  # noqa: E402
from sleekit_tpu_torch.ops import paged_attention as paged  # noqa: E402
from sleekit_tpu_torch.ops.attention import K3, K4, K10, K11  # noqa: E402
from sleekit_tpu_torch.ops.dequant_matmul import (  # noqa: E402
    K1, K2, K6, K7, K8, K9)
from sleekit_tpu_torch.ops.pack import (  # noqa: E402
    PackedLinear, pack_indices, unpack_indices)
from sleekit_tpu_torch.ops.paged_attention import K5, K14, K15  # noqa: E402
from sleekit_tpu_torch.serve.engine import Engine, Request  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate
# and the bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2 ** 20


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n_args: int, iters: int = 20, warmup: int = 3,
            graph: bool = True) -> float:
    """Mean time of ``fn(i)`` over ``iters`` calls, i cycling over
    ``n_args`` argument sets (so weights larger in total than L2 arrive
    cold, as they do layer after layer), between CUDA events. With
    ``graph`` the calls are captured in a CUDA graph and replayed, so the
    time is the device's alone, free of Python launch overhead; without
    it (the plain versions, which copy host scalars) it is eager."""
    for i in range(warmup):
        fn(i % n_args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(i % n_args)
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for i in range(iters):
            fn(i % n_args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(nbytes: int) -> int:
    """Argument sets needed to exceed twice the L2 size."""
    return max(1, min(32, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bf16_check(got, ref, what):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    tol = 2 ** -6 * ref.abs() + 1e-2 * ref.abs().max()
    if not torch.isfinite(got).all() or bool((err > tol).any()):
        raise AssertionError(f"{what}: max |err| {err.max().item():.4g} over "
                             f"the bf16 tolerance (rtol 2^-6, atol "
                             f"{1e-2 * ref.abs().max().item():.4g})")
    return err.max().item()


# ---- phase 2: each kernel at the slice's shapes -----------------------------


# The dequant-matmul kernels and the layout of their words: 4-bit 'pair'
# and 'plane', 3-bit 'pair3x' and 'pair3'.
LINEAR_LAYOUTS = {"K1": "pair", "K6": "pair3x", "K7": "pair3", "K8": "plane",
                  "K9": "plane"}


def layout_rows(layout, K):
    """Word rows of K rows in ``layout``."""
    return {"pair3x": K // 512 * 56, "pair3": -(-K // 256) * 24,
            "pair": -(-K // 256) * 32, "plane": -(-K // 256) * 32}[layout]


def layout_words(dev, gd, layout, K, N):
    """Random words of a (K, N) matrix (for 'pair3x', the top bit of each
    4-bit field 0)."""
    w = torch.randint(-2 ** 31, 2 ** 31, (layout_rows(layout, K), N),
                      dtype=torch.int64, device=dev, generator=gd
                      ).to(torch.int32)
    if layout == "pair3x":
        w.view(-1, 56, N)[:, :32] &= 0x77777777
    return w


def check_linears(dev, cfg, names):
    """Dequant-matmul kernels ``names`` on the four projections of a
    layer: K1 (int4 'pair'), K6 ('pair3x') and K7 ('pair3') with their
    prologues and residuals, K8 (the NF4 table) and K9 (the uniform int4
    grid) on 'plane' words with none (the model composes them), at decode
    M = 8 and at the largest prefill M (4 rows of the 256 bucket).
    Yardstick: ``torch.matmul`` on a bf16 weight of the same shape."""
    gd = torch.Generator(device=dev).manual_seed(len(names))
    d, ff = cfg.d_model, cfg.d_ff
    shapes = [("qkv", d, 3 * d, "layernorm", False),
              ("o", d, d, None, True),
              ("fc1", d, ff, "layernorm", False),
              ("fc2", ff, d, "relu", True)]
    nf4 = Codebook.nf4().values.to(dev)
    cases = {}
    for kern in names:
        layout = LINEAR_LAYOUTS[kern]
        cases[kern] = []
        for m in (8, 1024):
            for name, K, N, pre, res in shapes:
                if layout == "plane":
                    pre, res = None, False
                nbits = 3 if layout in ("pair3", "pair3x") else 4
                kw_rows = layout_rows(layout, K)
                n_copy = copies_for(kw_rows * N * 4 + K * N * 2)
                words = [layout_words(dev, gd, layout, K, N)
                         for _ in range(n_copy)]
                scale = 0.02 + 0.002 * torch.rand(N, device=dev, generator=gd)
                bias = 0.01 * torch.randn(N, device=dev, generator=gd)
                x = torch.randn(m, K, device=dev, generator=gd).to(
                    torch.bfloat16)
                kw = {}
                if kern in ("K1", "K6", "K7"):
                    if kern == "K1":
                        fn, plain = dm.pair_matmul, dm.pair_matmul_plain
                        kw = dict(nbits=4, a_aff=2.0 / 15 * 16,
                                  b_aff=-1.0 - 32 / 15)
                    else:
                        fn, plain = dm.pair3_matmul, dm.pair3_matmul_plain
                        kw = dict(a_aff=4 * 2.0 / 7, layout=layout,
                                  b_aff=-1.0 if layout == "pair3x"
                                  else -1.0 - 12 * 2.0 / 7)
                    kw.update(k=K, pre=pre, eps=1e-5)
                    if pre == "layernorm":
                        kw["ln_scale"] = torch.ones(K, dtype=torch.bfloat16,
                                                    device=dev)
                        kw["ln_bias"] = torch.zeros(K, dtype=torch.bfloat16,
                                                    device=dev)
                    if res:
                        kw["residual"] = torch.randn(
                            m, N, device=dev, generator=gd).to(torch.bfloat16)
                    extra = ()
                elif kern == "K8":
                    fn, plain = dm.plane_lut_matmul, dm.plane_lut_matmul_plain
                    kw = dict(nbits=4, k=K)
                    extra = (nf4,)
                else:
                    fn, plain = (dm.plane_affine_matmul,
                                 dm.plane_affine_matmul_plain)
                    kw = dict(nbits=4, k=K, a_aff=2.0 / 15 * 16,
                              b_aff=-1.0 - 32 / 15)
                    extra = ()

                def call(f, i, words=words, scale=scale, bias=bias, x=x,
                         kw=kw, extra=extra):
                    return f(x, words[i], scale, bias, *extra, **kw)
                got, want = call(fn, 0), call(plain, 0)
                torch.cuda.synchronize()
                err = bf16_check(got, want, f"{kern} {name} M={m}")
                ms = cuda_ms(lambda i: call(fn, i), n_copy)
                plain_ms = cuda_ms(lambda i: call(plain, i), n_copy, iters=5,
                                   warmup=1, graph=False)
                xp = dm._prologue_plain(x, pre, kw.get("ln_scale"),
                                        kw.get("ln_bias"), 1e-5, K)
                wdeq = [unpack_indices(w, nbits, K, layout).to(torch.bfloat16)
                        for w in words]
                lib_ms = cuda_ms(lambda i: torch.matmul(xp, wdeq[i]), n_copy)
                del wdeq
                nbytes = (x.numel() * 2 + kw_rows * N * 4 + 2 * N * 4
                          + m * N * 2
                          + (2 * K * 2 if pre == "layernorm" else 0)
                          + (m * N * 2 if res else 0)
                          + (16 * 4 if kern == "K8" else 0))
                b_ms, b_by = bound(nbytes, 2.0 * m * K * N)
                cases[kern].append(dict(
                    case=f"{name} M={m}", max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                    bound_by=b_by, bytes=nbytes))
                log(f"{kern} {name:4s} M={m:5d} K={K} N={N}: err {err:.3g} "
                    f"| kernel {ms:.4f} ms plain {plain_ms:.3f} ms matmul "
                    f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
                del words
    return cases


def check_k2(dev, g, cfg):
    """K2 on the int8 head (OPT-1.3B: 2048 x 51200 for vocab 50272) with
    the final layernorm prologue, decode M = 8."""
    K, V, m = cfg.d_model, cfg.vocab_size, 8
    Np = -(-V // 1024) * 1024
    packed = torch.randint(-128, 128, (K, Np), dtype=torch.int8,
                           generator=g).to(dev)
    scale = (0.001 * torch.rand(Np, generator=g)).to(dev)
    x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
    kw = dict(k=K, out_n=V, a_aff=2.0 / 255, b_aff=-1.0 + 128 * 2.0 / 255,
              pre="layernorm", eps=1e-5,
              ln_scale=torch.ones(K, dtype=torch.bfloat16, device=dev),
              ln_bias=torch.zeros(K, dtype=torch.bfloat16, device=dev))
    got = dm.int8_matmul(x, packed, scale, None, **kw)
    want = dm.int8_matmul_plain(x, packed, scale, None, **kw)
    torch.cuda.synchronize()
    err = bf16_check(got, want, "K2 head")
    ms = cuda_ms(lambda i: dm.int8_matmul(x, packed, scale, None, **kw), 1)
    plain_ms = cuda_ms(lambda i: dm.int8_matmul_plain(
        x, packed, scale, None, **kw), 1, iters=5, warmup=1, graph=False)
    xp = dm._prologue_plain(x, "layernorm", kw["ln_scale"], kw["ln_bias"],
                            1e-5, K)
    wdeq = packed[:, :V].to(torch.bfloat16)
    lib_ms = cuda_ms(lambda i: torch.matmul(xp, wdeq), 1)
    nbytes = x.numel() * 2 + K * Np + Np * 4 + m * V * 2 + 2 * K * 2
    b_ms, b_by = bound(nbytes, 2.0 * m * K * V)
    log(f"K2 head M={m} K={K} N={V}: err {err:.3g} | kernel {ms:.4f} ms "
        f"plain {plain_ms:.3f} ms matmul {lib_ms:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by})")
    return [dict(case="head M=8", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                 bytes=nbytes)]


def check_k3(dev, g, cfg):
    """K3 at serving decode (OPT-1.3B: B 8, H = KV 32, D 64, S 512, 24
    layers of int8 cache with bf16 scales), scalar and ragged positions."""
    L, B, H, S, D = cfg.n_layers, 8, cfg.n_heads, 512, cfg.head_dim
    kq, ks = attn._quant_rows(torch.randn(L, B, H, S, D, device=dev))
    vq, vs = attn._quant_rows(torch.randn(L, B, H, S, D, device=dev))
    ks, vs = ks[..., 0].bfloat16(), vs[..., 0].bfloat16()
    q = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    kn = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    vn = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    cases = []
    ragged = torch.tensor([17, 100, 200, 256, 300, 400, 511, 60],
                          dtype=torch.int32, device=dev)
    for label, pos in (("pos 256", 256), ("ragged pos", ragged)):
        planes = [kq, vq, ks, vs]
        ref = [t.clone() for t in planes]
        got = attn.fused_decode_append(q, kn, vn, planes[0], planes[1], pos,
                                       L - 1, scale, k_scale=planes[2],
                                       v_scale=planes[3])
        want = attn.fused_decode_append_plain(q, kn, vn, ref[0], ref[1], pos,
                                              L - 1, scale, k_scale=ref[2],
                                              v_scale=ref[3])
        torch.cuda.synchronize()
        err = bf16_check(got[0], want[0], f"K3 {label}")
        for a, b in zip(got[1:], want[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"K3 {label}: written cache differs")
        ms = cuda_ms(lambda i: attn.fused_decode_append(
            q, kn, vn, kq, vq, pos, i, scale, k_scale=ks, v_scale=vs), L)
        plain_ms = cuda_ms(lambda i: attn.fused_decode_append_plain(
            q, kn, vn, ref[0], ref[1], pos, i, scale, k_scale=ref[2],
            v_scale=ref[3]), L, iters=5, warmup=1, graph=False)
        p = torch.clamp(torch.as_tensor(pos, device=dev).expand(B), 0, S - 1)
        rows = int((p + 1).sum().item()) * H     # (p+1) rows per (b, head)
        nbytes = (rows * (2 * D + 2 * 2) + 3 * B * H * D * 2 + B * H * D * 2)
        b_ms, b_by = bound(nbytes, 4.0 * rows * D)
        lib_ms = None
        if label == "pos 256":
            n_lay = min(4, L)
            kd = [(kq[i, :, :, :257].float()
                   * ks[i, :, :, :257, None].float()).bfloat16()
                  for i in range(n_lay)]
            vd = [(vq[i, :, :, :257].float()
                   * vs[i, :, :, :257, None].float()).bfloat16()
                  for i in range(n_lay)]
            lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
                q[:, :, None], kd[i], vd[i]), n_lay)
        cases.append(dict(case=label, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
        sdpa = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"K3 {label}: err {err:.3g}, cache rows and scales equal | kernel "
            f"{ms:.4f} ms plain {plain_ms:.3f} ms sdpa {sdpa} bound "
            f"{b_ms:.4f} ms ({b_by})")
    return cases


def check_k4(dev, g, cfg):
    """K4 at the 256-token prompt bucket: 4 rows (OPT-1.3B: H = KV 32,
    D 64)."""
    B, T, H, D = 4, 256, cfg.n_heads, cfg.head_dim
    q = torch.randn(B, T, H, D, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(B, H, T, D, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(B, H, T, D, generator=g).to(dev, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    got = attn.flash_prefill(q, k, v, scale)
    want = attn.flash_prefill_plain(q, k, v, scale)
    torch.cuda.synchronize()
    err = bf16_check(got, want, "K4")
    ms = cuda_ms(lambda i: attn.flash_prefill(q, k, v, scale), 1)
    plain_ms = cuda_ms(lambda i: attn.flash_prefill_plain(q, k, v, scale), 1,
                       iters=5, warmup=1, graph=False)
    qh = q.transpose(1, 2)
    lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qh, k, v, is_causal=True), 1)
    nbytes = 4 * B * T * H * D * 2
    b_ms, b_by = bound(nbytes, 4.0 * B * H * D * T * (T + 1) / 2)
    log(f"K4 T={T} B={B}: err {err:.3g} | kernel {ms:.4f} ms plain "
        f"{plain_ms:.3f} ms sdpa {lib_ms:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by})")
    return [dict(case=f"T={T} B={B}", max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, bytes=nbytes)]


# Page geometry of the paged phases: OPT-1.3B serving pages of 64 rows, 8
# logical pages (512 rows) per sequence.
PS, MAXP = 64, 8


def strided_table(B: int, dev) -> torch.Tensor:
    """Row b's logical page j in physical page 1 + (MAXP-1-j)*B + b:
    distinct pages, strided across rows and in reverse order; page 0 is
    the trash page and stays unused."""
    j = torch.arange(MAXP)[None, :]
    b = torch.arange(B)[:, None]
    return (1 + (MAXP - 1 - j) * B + b).to(torch.int32).to(dev)


def to_pool(x, table):
    """A slot-cache plane (L, B, KV, S[, D]) laid out page by page into a
    pool (L, 1 + B*S/PS, KV, PS[, D]) through ``table``."""
    L, B, KV, S = x.shape[:4]
    rest = x.shape[4:]
    pages = x.reshape(L, B, KV, S // PS, PS, *rest).transpose(2, 3)
    pool = torch.zeros((L, 1 + B * S // PS, KV, PS, *rest), dtype=x.dtype,
                       device=x.device)
    pool[:, table.reshape(-1).long()] = pages.reshape(L, -1, KV, PS, *rest)
    return pool


def decode_bytes(p, H, D, fused: bool, paged: bool):
    """Bytes one decode-attention kernel must move at positions ``p`` (B,)
    over an int8 cache with bf16 scales: the cache rows it reads or writes
    ((p + 1) per batch row and head, each 2*D int8 plus two bf16 scales),
    q and the output (and the new K/V when fused), and the table entries
    of the pages those rows live in. Returns (bytes, rows)."""
    B = p.numel()
    rows = int((p + 1).sum().item()) * H
    nbytes = rows * (2 * D + 2 * 2) + (4 if fused else 2) * B * H * D * 2
    if paged:
        nbytes += int((p // PS + 1).sum().item()) * 4
    return nbytes, rows


def check_paged(dev, g, cfg):
    """The page-pool kernels K5, K14 and K15 and the split route's slot
    kernels K10 and K11 at serving decode (OPT-1.3B: B 8, H = KV 32, D 64,
    24 layers of int8 cache with bf16 scales, PS 64, MAXP 8, a strided
    out-of-order table of distinct pages), scalar and ragged positions.
    The pool holds the slot cache's rows page by page, so K5 is held to K3
    on the same logical rows: output and written bytes equal."""
    L, B, H, D = cfg.n_layers, 8, cfg.n_heads, cfg.head_dim
    S = PS * MAXP
    gd = torch.Generator(device=dev).manual_seed(1)
    kq, ks = attn._quant_rows(torch.randn(L, B, H, S, D, device=dev,
                                          generator=gd))
    vq, vs = attn._quant_rows(torch.randn(L, B, H, S, D, device=dev,
                                          generator=gd))
    slot = [kq, vq, ks[..., 0].bfloat16(), vs[..., 0].bfloat16()]
    del kq, vq, ks, vs
    table = strided_table(B, dev)
    pool = [to_pool(x, table) for x in slot]
    q = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    kn = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    vn = torch.randn(B, H, D, generator=g).to(dev, torch.bfloat16)
    scale = 1.0 / math.sqrt(D)
    ragged = torch.tensor([17, 100, 200, 256, 300, 400, 511, 60],
                          dtype=torch.int32, device=dev)
    cases = {name: [] for name in ("K5", "K10", "K11", "K14", "K15")}

    def clone(planes):
        return [t.clone() for t in planes]

    def sdpa_ms(planes, gather):
        """SDPA over the rows s <= 256 dequantized to bf16 (4 layers)."""
        def rows(x, i):
            return (paged._gathered(x, table, i) if gather else x[i])[:, :,
                                                                     :257]
        n_lay = min(4, L)
        kd = [(rows(planes[0], i).float() * rows(planes[2], i)[..., None]
               .float()).bfloat16() for i in range(n_lay)]
        vd = [(rows(planes[1], i).float() * rows(planes[3], i)[..., None]
               .float()).bfloat16() for i in range(n_lay)]
        return cuda_ms(lambda i: F.scaled_dot_product_attention(
            q[:, :, None], kd[i], vd[i]), n_lay)

    def record(name, label, err, ms, plain_ms, lib_ms, nbytes, flops):
        b_ms, b_by = bound(nbytes, flops)
        cases[name].append(dict(case=label, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"{name} {label}: err {err:.3g} | kernel {ms:.4f} ms plain "
            f"{plain_ms:.3f} ms library {lib} bound {b_ms:.4f} ms ({b_by})")

    def equal(got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: written bytes differ")

    for label, pos in (("pos 256", 256), ("ragged pos", ragged)):
        p = torch.clamp(torch.as_tensor(pos, device=dev).expand(B), 0, S - 1)
        lib = label == "pos 256"

        # K5 against its plain version, and against K3 on the slot rows.
        got_p, ref_p, got_s = clone(pool), clone(pool), clone(slot)
        got = paged.paged_fused_decode_append(
            q, kn, vn, got_p[0], got_p[1], table, pos, L - 1, scale,
            k_scale=got_p[2], v_scale=got_p[3])
        want = paged.paged_fused_decode_append_plain(
            q, kn, vn, ref_p[0], ref_p[1], table, pos, L - 1, scale,
            k_scale=ref_p[2], v_scale=ref_p[3])
        k3 = attn.fused_decode_append(q, kn, vn, got_s[0], got_s[1], pos,
                                      L - 1, scale, k_scale=got_s[2],
                                      v_scale=got_s[3])
        torch.cuda.synchronize()
        err = bf16_check(got[0], want[0], f"K5 {label}")
        equal(got[1:], want[1:], f"K5 {label} vs plain")
        if not torch.equal(got[0], k3[0]):
            raise AssertionError(f"K5 {label}: output differs from K3's")
        equal(got[1:], [to_pool(x, table) for x in k3[1:]],
              f"K5 {label} vs K3")
        nbytes, rows = decode_bytes(p, H, D, True, True)
        record("K5", label, err, cuda_ms(
            lambda i: paged.paged_fused_decode_append(
                q, kn, vn, got_p[0], got_p[1], table, pos, i, scale,
                k_scale=got_p[2], v_scale=got_p[3]), L),
            cuda_ms(lambda i: paged.paged_fused_decode_append_plain(
                q, kn, vn, ref_p[0], ref_p[1], table, pos, i, scale,
                k_scale=ref_p[2], v_scale=ref_p[3]), L, iters=5, warmup=1,
                graph=False),
            sdpa_ms(pool, True) if lib else None, nbytes, 4.0 * rows * D)
        log(f"K5 {label}: output and written bytes equal K3's on the same "
            f"logical rows")
        del got_p, ref_p, got_s, got, want, k3

        # K15 and K11: flash decode over s <= pos.
        for name, planes, fn, plain, extra in (
                ("K15", pool, paged.paged_flash_decode,
                 paged.paged_flash_decode_plain, (table,)),
                ("K11", slot, attn.flash_decode, attn.flash_decode_plain,
                 ())):
            def call(f, i, planes=planes, extra=extra):
                return f(q, planes[0], planes[1], *extra, pos, i, scale,
                         None, planes[2], planes[3])
            got = call(fn, L - 1)
            want = call(plain, L - 1)
            torch.cuda.synchronize()
            err = bf16_check(got, want, f"{name} {label}")
            nbytes, rows = decode_bytes(p, H, D, False, name == "K15")
            record(name, label, err, cuda_ms(lambda i: call(fn, i), L),
                   cuda_ms(lambda i: call(plain, i), L, iters=5, warmup=1,
                           graph=False),
                   sdpa_ms(planes, name == "K15") if lib else None, nbytes,
                   4.0 * rows * D)

        # K14 and K10: the append alone.
        for name, planes, fn, plain, extra in (
                ("K14", pool, paged.paged_kv_append,
                 paged.paged_kv_append_plain, (table,)),
                ("K10", slot, attn.kv_append, attn.kv_append_plain, ())):
            got_c, ref_c = clone(planes), clone(planes)

            def call(f, c, i, extra=extra):
                return f(kn, vn, c[0], c[1], *extra, pos, i, c[2], c[3])
            call(fn, got_c, L - 1)
            call(plain, ref_c, L - 1)
            torch.cuda.synchronize()
            equal(got_c, ref_c, f"{name} {label}")
            nbytes = (2 * B * H * D * 2 + B * H * (2 * D + 2 * 2)
                      + (B * 4 if extra else 0))
            record(name, label, 0.0, cuda_ms(lambda i: call(fn, got_c, i),
                                             L),
                   cuda_ms(lambda i: call(plain, ref_c, i), L, iters=5,
                           warmup=1, graph=False),
                   None, nbytes, 4.0 * B * H * D)
            del got_c, ref_c
    return cases


# ---- phase 3: the Engine ------------------------------------------------------


PROMPT_LENS = [12, 30, 50, 100, 140, 200, 250, 20]   # buckets 16..256
NEW_TOKENS = 32


def run_engine(dev, cfg, card: str):
    """The int4 'pair' model (K1) served as ``serve`` says; ``card``: the
    card's name and power limit, printed beside the decode rate. Returns
    (launches, metrics, the state later phases reuse)."""
    t0 = time.perf_counter()
    params, _ = random_packed_params(cfg, seed=0, fuse_qkv=True,
                                     layout="pair", device=dev)
    params = pack_lm_head(cfg, params, nbits=8)
    torch.cuda.synchronize()
    log(f"random int4 pair params + int8 head: "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    launches, metrics, _, engine, comps = serve(
        dev, cfg, card, "int4", params, K1, prompts, NEW_TOKENS)
    state = dict(params=params, prompts=prompts, cache=engine.cache,
                 tokens=[c.tokens for c in comps])
    return launches, metrics, state


def serve(dev, cfg, card, what, params, kernel, prompts, n_new, hold=True):
    """Serve the prompts (greedy, ``n_new`` tokens each) through the slot
    Engine on ``params``, whose linears all run ``kernel``; check the
    launches of the run and of one decode step through the public entry
    point (exactly 4 per layer of ``kernel``: qkv, o, fc1, fc2; one K2
    head; one K3 per layer), the prefill logits (kernels vs plain
    versions; ``hold``: see check_prefill) and each layer, and time
    batch-8 decode. Returns (the run's launches, metrics, the kernels'
    full-depth prefill logits, the Engine, its completions)."""
    engine = Engine(cfg, params, max_slots=8, max_seq_len=512,
                    cache_dtype=torch.int8, device=dev, use_kernel=True)
    reqs = [Request(prompt=p, max_new_tokens=n_new) for p in prompts]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: n for k, n in counts().items() if n}
    log(f"{what} Engine: 8 requests x {n_new} tokens in {run_s:.2f} s; "
        f"launches {launches}")
    if set(launches) != {kernel.name, "K2", "K3", "K4"}:
        raise AssertionError(f"{what}: the Engine launched {launches}")
    check_completions(comps, prompts, cfg, f"{what} Engine", n_new)

    kernels.reset_launch_counts()
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    logits, _ = decode_step(cfg, params, tok, engine.cache, 300,
                            use_kernel=True)
    torch.cuda.synchronize()
    step = {k: n for k, n in counts().items() if n}
    if step != {kernel.name: 4 * cfg.n_layers, "K2": 1, "K3": cfg.n_layers}:
        raise AssertionError(f"{what}: one decode step launched {step}")
    if logits.shape != (8, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{what}: decode logits not finite (8, vocab)")
    log(f"{what}: one decode step launches {step}")

    toks = group_tokens(prompts, dev)
    err1, rel, agree, full = check_prefill(dev, cfg, params, toks,
                                           f"{what} ", hold)
    layers_err = check_layers(dev, cfg, params, toks, f"{what} ")
    ms_step, dev_ms = time_decode(dev, cfg, params, engine.cache, card,
                                  f"{what} decode")
    metrics = {"engine_run_s": run_s, "decode_ms_per_step": ms_step,
               "decode_tokens_per_s": 8e3 / ms_step,
               "decode_step_graph_ms": dev_ms,
               "prefill_layer1_max_err": err1, "prefill_full_rel_l2": rel,
               "prefill_full_argmax_agree": agree,
               "layers_max_err": layers_err}
    return (launches, {f"{what}_{k}": v for k, v in metrics.items()}, full,
            engine, comps)


def group_tokens(prompts, dev):
    """The 256-bucket admission group: (its 3 prompts in 4 rows, 3)."""
    group = [p for p in prompts if 128 < len(p) <= 256]
    toks = np.zeros((4, 256), np.int32)
    for r, p in enumerate(group):
        toks[r, :len(p)] = p
    return torch.as_tensor(toks, dtype=torch.int64, device=dev), len(group)


def prefill_logits(dev, cfg, params, toks, n_layers, use_kernel):
    """Logits of the group's prompts (``toks``: group_tokens' pair)."""
    rows, n = toks
    c = dataclasses.replace(cfg, n_layers=n_layers)
    cache = init_kv_cache(c, rows.shape[0], 256, torch.int8, device=dev)
    logits, _ = prefill(c, dict(params, layers=params["layers"][:n_layers]),
                        rows, cache, use_kernel=use_kernel)
    return logits[:n].float()


def rel_l2(got, want, what, hold=True):
    """Relative L2 of ``got`` against ``want`` and their argmax agreement;
    raises if ``got`` is not finite or, when ``hold``, the L2 is over
    2^-6."""
    rel = ((got - want).norm() / want.norm()).item()
    if not torch.isfinite(got).all() or (hold and not rel <= 2 ** -6):
        raise AssertionError(f"{what}: relative L2 {rel:.4g} over 2^-6")
    return rel, (got.argmax(-1) == want.argmax(-1)).float().mean().item()


def check_layers(dev, cfg, params, toks, what):
    """Every layer at full depth, the kernels against their plain versions
    on the same input (the kernel path's hidden state, so no difference
    carries from one layer to the next): within the bf16 tolerance.
    Returns the largest max |err|."""
    rows, n = toks
    positions = torch.arange(rows.shape[1], device=dev).expand(*rows.shape)
    slopes = tr._slopes(cfg, dev)
    x = tr._embed(cfg, params, rows, positions, True)
    worst = 0.0
    for i, layer in enumerate(params["layers"]):
        got = tr._block(cfg, layer, x, positions, None, slopes, True)
        want = tr._block(cfg, layer, x, positions, None, slopes, False)
        worst = max(worst, bf16_check(got[:n], want[:n],
                                      f"{what}layer {i}, kernels vs plain"))
        x = got
    log(f"{what}each of {cfg.n_layers} layers on the kernel path's input, "
        f"kernels vs plain versions: max |err| {worst:.4g} (bf16 tolerance)")
    return worst


def check_prefill(dev, cfg, params, toks, what, hold=True):
    """The group prefilled through the prefill entry point with the kernels
    and with their plain versions on the card (use_kernel=False). Through
    the first layer and the head, the logits agree within the bf16
    tolerance. Through all layers they cannot: the two sum in different
    orders, each op's outputs then differ by one bf16 step in about 1e-4
    to 1e-3 of their elements, and the next wide product spreads that to
    most elements, layer after layer (42% of the logits differ after one
    layer, 86% after 24, relative L2 3e-3 -> 1.25e-2, H100 700 W, this
    script's data). Full depth is held to a relative L2 of at most 2^-6,
    or only measured without ``hold``. Returns (layer-1 max error,
    full-depth relative L2, argmax agreement, the kernels' full-depth
    logits)."""
    err1 = bf16_check(prefill_logits(dev, cfg, params, toks, 1, True),
                      prefill_logits(dev, cfg, params, toks, 1, False),
                      f"{what}prefill logits through layer 1, kernels vs "
                      "plain")
    got = prefill_logits(dev, cfg, params, toks, cfg.n_layers, True)
    want = prefill_logits(dev, cfg, params, toks, cfg.n_layers, False)
    rel, agree = rel_l2(got, want, f"{what}prefill logits through "
                        f"{cfg.n_layers} layers", hold)
    log(f"{what}prefill logits (3 prompts, bucket 256), kernels vs plain "
        f"versions: layer 1 max |err| {err1:.4g} (bf16 tolerance); "
        f"{cfg.n_layers} layers relative L2 {rel:.4g} "
        f"({'<= 2^-6' if hold else 'measured, not held'}), max |err| "
        f"{(got - want).abs().max().item():.4g}, argmax agreement {agree:.4f}")
    return err1, rel, agree, got


def time_decode(dev, cfg, params, cache, card, what):
    """Batch-8 greedy decode rate over ``cache`` from ctx 256 (eager:
    Python issues every launch), and one decode step's device time at ctx
    288 (the same step captured in a CUDA graph and replayed). Returns
    (eager ms/step, graph ms)."""
    steps = 32
    last = torch.zeros(8, dtype=torch.int32, device=dev)
    decode_scan(cfg, params, cache, last, 256, 4, use_kernel=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_scan(cfg, params, cache, last, 256, steps, use_kernel=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    dev_ms = cuda_ms(lambda i: decode_step(cfg, params, tok, cache, 288,
                                           use_kernel=True), 1, iters=4)
    log(f"{what}: batch 8, ctx 256-{256 + steps}, {steps} steps: "
        f"{dt / steps * 1e3:.3f} ms/step, {8 * steps / dt:.1f} tokens/s; one "
        f"step replayed as a CUDA graph: {dev_ms:.3f} ms ({card})")
    return dt / steps * 1e3, dev_ms


def counts():
    return {k.name: k.launches for k in kernels.KERNELS}


def check_completions(comps, prompts, cfg, what, n_new=NEW_TOKENS):
    for c, p in zip(comps, prompts):
        if (len(c.new_tokens) != n_new or c.finish_reason != "length"
                or not ((c.new_tokens >= 0)
                        & (c.new_tokens < cfg.vocab_size)).all()
                or not np.array_equal(c.tokens[:len(p)], p)):
            raise AssertionError(f"{what}: bad completion {c.request_id}")


def serve_paged(engine, reqs):
    """Submit ``reqs``, take the first step (admission, one decode step)
    and a second, pure decode step, then step until drained. Returns
    (completions in submission order, the second step's launches, the
    queue left after the first step)."""
    ids = [engine.submit(r) for r in reqs]
    engine.step()
    queued = len(engine.queue)
    before = counts()
    engine.step()
    torch.cuda.synchronize()
    step = {k: n - before[k] for k, n in counts().items()}
    while engine.has_work():
        engine.step_auto()
    by_id = {c.request_id: c for c in engine.finished}
    return [by_id[i] for i in ids], step, queued


def run_paged_engine(dev, cfg, card: str, state):
    """The paged Engine (page pool of 64-row pages) on the slot phase's
    params and requests. Run A, default pool: all 8 requests admitted at
    once, the slot Engine's tokens, 96 K1 + 1 K2 + 24 K5 (no K3) per
    decode step. Run B, 17 pages (16 usable of the 20 the requests need):
    admission blocks, pages are recycled. Then decode through a pool that
    holds the slot cache's rows: the slot cache's logits bit for bit, and
    its rate. Returns (run A's launches, metrics, that pool)."""
    params, prompts = state["params"], state["prompts"]

    def engine(**kw):
        return Engine(cfg, params, max_slots=8, max_seq_len=512,
                      cache_dtype=torch.int8, paged=True, page_size=PS,
                      device=dev, use_kernel=True, **kw)

    def requests():
        return [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]

    eng = engine()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    comps, step, queued = serve_paged(eng, requests())
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    log(f"paged Engine run A ({eng.total_pages} pages of {PS}): 8 requests "
        f"x {NEW_TOKENS} tokens in {run_s:.2f} s; launches "
        f"{ {k: n for k, n in launches.items() if n} }")
    if queued:
        raise AssertionError("run A: the default pool did not admit all 8")
    for name in ("K1", "K2", "K4", "K5"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the paged path")
    want = {"K1": 4 * cfg.n_layers, "K2": 1, "K5": cfg.n_layers}
    if {k: n for k, n in step.items() if n} != want:
        raise AssertionError(f"one paged decode step launched {step}")
    log(f"one paged decode step launches {want}, no K3")
    check_completions(comps, prompts, cfg, "paged run A")
    for c, tokens in zip(comps, state["tokens"]):
        if not np.array_equal(c.tokens, tokens):
            raise AssertionError(f"paged run A: request {c.request_id}'s "
                                 f"tokens differ from the slot Engine's")
    log("paged run A: greedy tokens equal the slot Engine's")
    if (sorted(eng._free_pages) != list(range(1, eng.total_pages))
            or eng._slot_pages):
        raise AssertionError("paged run A: pages not returned")

    eng_b = engine(total_pages=17)
    kernels.reset_launch_counts()
    comps_b, _, queued = serve_paged(eng_b, requests())
    torch.cuda.synchronize()
    check_completions(comps_b, prompts, cfg, "paged run B")
    if not queued or K5.launches <= 0:
        raise AssertionError(f"paged run B: {queued} requests queued after "
                             f"the first admission, {K5.launches} K5")
    if (sorted(eng_b._free_pages) != list(range(1, 17))
            or eng_b._slot_pages):
        raise AssertionError("paged run B: pages not returned")
    agree = np.mean([np.mean(a.new_tokens == b.new_tokens)
                     for a, b in zip(comps_b, comps)])
    log(f"paged run B (17 pages): {queued} of 8 requests waited for pages; "
        f"all pages returned; new-token agreement with run A {agree:.4f} "
        f"(prefill groups differ)")

    # Decode through a pool holding the slot cache's rows, strided and out
    # of order: the slot cache's logits bit for bit, then the rate.
    table = strided_table(8, dev)
    pool = {k: to_pool(v, table) for k, v in state["cache"].items()}
    pool["page_table"] = table
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    slot_cache = {k: v.clone() for k, v in state["cache"].items()}
    want, _ = decode_step(cfg, params, tok, slot_cache, 256, use_kernel=True)
    got, _ = decode_step(cfg, params, tok, pool, 256, use_kernel=True)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("decode through the pool: logits differ from "
                             "the slot cache's")
    del slot_cache
    last = torch.zeros(8, dtype=torch.int32, device=dev)
    decode_scan(cfg, params, pool, last, 256, 4, use_kernel=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 32
    decode_scan(cfg, params, pool, last, 256, steps, use_kernel=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dev_ms = cuda_ms(lambda i: decode_step(cfg, params, tok, pool, 288,
                                           use_kernel=True), 1, iters=4)
    log(f"paged decode: logits at ctx 256 equal the slot cache's; batch 8, "
        f"ctx 256-288, {steps} steps: {dt / steps * 1e3:.3f} ms/step, "
        f"{8 * steps / dt:.1f} tokens/s; one step replayed as a CUDA graph: "
        f"{dev_ms:.3f} ms ({card})")
    return launches, dict(paged_run_s=run_s, paged_pages=eng.total_pages,
                          paged_small_pool_agree=float(agree),
                          paged_decode_ms_per_step=dt / steps * 1e3,
                          paged_decode_tokens_per_s=8 * steps / dt,
                          paged_decode_step_graph_ms=dev_ms), pool


def run_split(dev, cfg, state, pool):
    """One decode step on the split route (FLASH_FUSED_APPEND off) over
    the slot cache and over the pool, each after the fused route's step
    at the same position (every row active): 24 K10 + 24 K11, then 24 K14
    + 24 K15. Through the first layer the logits agree with the fused
    route's within the bf16 tolerance; through all 24, within a relative
    L2 of 2^-6, for the reason the prefill check gives (the two sum the
    new token in another order, and each wide product spreads one bf16
    step). Then times one step on each route as a CUDA graph. Returns
    (each split kernel's launches, the step times)."""
    params = state["params"]
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    launches, metrics = {}, {}

    def both(n_layers, cache):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        p = dict(params, layers=params["layers"][:n_layers])
        cache = {k: v if k == "page_table" else v[:n_layers]
                 for k, v in cache.items()}
        fused, _ = decode_step(c, p, tok, cache, 300, use_kernel=True)
        attn.FLASH_FUSED_APPEND = False
        try:
            kernels.reset_launch_counts()
            split, _ = decode_step(c, p, tok, cache, 300, use_kernel=True)
            torch.cuda.synchronize()
            step = counts()
        finally:
            attn.FLASH_FUSED_APPEND = True
        return fused.float(), split.float(), step

    def step_ms(cache, fused_route):
        attn.FLASH_FUSED_APPEND = fused_route
        try:
            return cuda_ms(lambda i: decode_step(cfg, params, tok, cache, 300,
                                                 use_kernel=True), 1, iters=4)
        finally:
            attn.FLASH_FUSED_APPEND = True

    for mode, cache, names in (("slot", state["cache"], ("K10", "K11")),
                               ("paged", pool, ("K14", "K15"))):
        fused, split, _ = both(1, cache)
        err1 = bf16_check(split, fused,
                          f"split route ({mode}) logits through layer 1")
        fused, split, step = both(cfg.n_layers, cache)
        want = {"K1": 4 * cfg.n_layers, "K2": 1, names[0]: cfg.n_layers,
                names[1]: cfg.n_layers}
        if {k: n for k, n in step.items() if n} != want:
            raise AssertionError(f"split route ({mode}): one step launched "
                                 f"{step}")
        rel = ((split - fused).norm() / fused.norm()).item()
        if not rel <= 2 ** -6 or not torch.isfinite(split).all():
            raise AssertionError(f"split route ({mode}): relative L2 "
                                 f"{rel:.4g} over 2^-6")
        launches.update({n: step[n] for n in names})
        agree = (split.argmax(-1) == fused.argmax(-1)).float().mean().item()
        log(f"split route ({mode}): one decode step launches {want}; logits "
            f"vs the fused route's: layer 1 max |err| {err1:.4g} (bf16 "
            f"tolerance), {cfg.n_layers} layers relative L2 {rel:.4g} "
            f"(<= 2^-6), max |err| {(split - fused).abs().max().item():.4g}, "
            f"argmax agreement {agree:.4f}")
        ms = {route: step_ms(cache, route == "fused")
              for route in ("fused", "split")}
        metrics.update({f"{mode}_{route}_step_graph_ms": t
                        for route, t in ms.items()})
        log(f"split route ({mode}): one decode step at ctx 300 replayed as a "
            f"CUDA graph: {ms['split']:.3f} ms, fused route {ms['fused']:.3f} "
            f"ms")
    return launches, metrics


# ---- phase 7: the 3-bit and 'plane' layouts through the Engine (K6-K9) -----


LAYOUT_NEW_TOKENS = 16


def repack(tree, layout, src):
    """``tree`` with every ``src``-layout PackedLinear's indices repacked
    as ``layout`` on its device (unpack_indices / pack_indices)."""
    if isinstance(tree, PackedLinear) and tree.layout == src:
        idx = unpack_indices(tree.packed, tree.nbits, tree.in_features, src)
        return dataclasses.replace(
            tree, packed=pack_indices(idx, tree.nbits, layout=layout),
            layout=layout)
    if isinstance(tree, dict):
        return {k: repack(v, layout, src) for k, v in tree.items()}
    if isinstance(tree, list):
        return [repack(v, layout, src) for v in tree]
    return tree


def run_layouts(dev, cfg, card, state):
    """The int3 'pair3x' model (K6), its indices repacked as 'pair3' (K7),
    the NF4 'plane' model (K8), each served as ``serve`` says; then
    the int4 model's indices repacked as 'plane' (K9). Returns (each
    kernel's launches on its path, metrics)."""
    prompts = state["prompts"]
    launches, metrics = {}, {}
    t0 = time.perf_counter()
    p3x, _ = random_packed_params(cfg, seed=0, fuse_qkv=True,
                                  codebook=UniformCodebook(8, -1.0, 1.0),
                                  layout="pair3x", device=dev)
    p3x = pack_lm_head(cfg, p3x, nbits=8)
    torch.cuda.synchronize()
    log(f"random int3 pair3x params + int8 head: "
        f"{time.perf_counter() - t0:.1f} s")
    run, m, full_p3x, _, _ = serve(dev, cfg, card, "int3", p3x, K6, prompts,
                                   LAYOUT_NEW_TOKENS)
    launches["K6"] = run["K6"]
    metrics.update(m)
    p3 = repack(p3x, "pair3", "pair3x")
    del p3x
    run, m, full_p3, _, _ = serve(dev, cfg, card, "int3p", p3, K7, prompts,
                                  LAYOUT_NEW_TOKENS)
    launches["K7"] = run["K7"]
    metrics.update(m)
    rel, agree = rel_l2(full_p3, full_p3x, "pair3 vs pair3x prefill logits")
    metrics["int3p_vs_int3_rel_l2"] = rel
    log(f"int3p vs int3 (the same indices through K7 and K6): {cfg.n_layers}"
        f" layers relative L2 {rel:.4g} (<= 2^-6), argmax agreement "
        f"{agree:.4f}")
    del p3, full_p3, full_p3x

    nf4, _ = random_packed_params(cfg, seed=0, fuse_qkv=True,
                                  codebook=Codebook.nf4(), layout="plane",
                                  device=dev)
    nf4 = pack_lm_head(cfg, nf4, nbits=8)
    # The random NF4 model drifts: its table's mean is +0.023, so uniform
    # random indices bias every layer the same way, and the kernels' and
    # plain versions' bf16 differences grow with depth past 2^-6. So its
    # full-depth logits are measured (and at 8 layers), its 24 layers held
    # one by one, and K8's full depth is held on the same indices over the
    # NF4 table with its mean taken out, a model that does not drift.
    run, m, _, _, _ = serve(dev, cfg, card, "nf4", nf4, K8, prompts,
                            LAYOUT_NEW_TOKENS, hold=False)
    launches["K8"] = run["K8"]
    metrics.update(m)
    toks = group_tokens(prompts, dev)

    def kernels_vs_plain(params, n_layers, what, hold):
        return rel_l2(prefill_logits(dev, cfg, params, toks, n_layers, True),
                      prefill_logits(dev, cfg, params, toks, n_layers, False),
                      what, hold)[0]
    rel8 = kernels_vs_plain(nf4, 8, "nf4 8 layers", False)
    del nf4
    values = Codebook.nf4().values
    centred, _ = random_packed_params(
        cfg, seed=0, fuse_qkv=True, layout="plane", device=dev,
        codebook=Codebook.create((values - values.mean()).numpy()))
    centred = pack_lm_head(cfg, centred, nbits=8)
    rel_c = kernels_vs_plain(centred, cfg.n_layers,
                             "centred NF4 prefill logits", True)
    del centred
    metrics.update(nf4_prefill_8_layers_rel_l2=rel8,
                   nf4_centred_prefill_full_rel_l2=rel_c)
    log(f"nf4 prefill logits, kernels vs plain versions: 8 layers relative "
        f"L2 {rel8:.4g} (measured); the same indices over the table minus "
        f"its mean: {cfg.n_layers} layers relative L2 {rel_c:.4g} (<= 2^-6)")

    # int4 'plane': the int4 model's own indices, so the 'pair' path (K1)
    # is the reference for its logits; decode over the int4 Engine's cache.
    plane = repack(state["params"], "plane", "pair")
    kernels.reset_launch_counts()
    got = prefill_logits(dev, cfg, plane, toks, cfg.n_layers, True)
    torch.cuda.synchronize()
    pre_launches = counts()["K9"]
    want = prefill_logits(dev, cfg, state["params"], toks, cfg.n_layers,
                          True)
    rel, agree = rel_l2(got, want, "int4 plane vs pair prefill logits")
    layers_err = check_layers(dev, cfg, plane, toks, "int4 plane ")
    cache = {k: v.clone() for k, v in state["cache"].items()}
    last = torch.zeros(8, dtype=torch.int32, device=dev)
    steps = 4
    kernels.reset_launch_counts()
    decode_scan(cfg, plane, cache, last, 256, steps, use_kernel=True)
    torch.cuda.synchronize()
    step = {k: n for k, n in counts().items() if n}
    want_step = {"K9": 4 * cfg.n_layers * steps, "K2": steps,
                 "K3": cfg.n_layers * steps}
    if step != want_step or pre_launches != 4 * cfg.n_layers:
        raise AssertionError(f"int4 plane: {pre_launches} K9 in prefill, "
                             f"{steps} decode steps launched {step}")
    launches["K9"] = pre_launches + step["K9"]
    log(f"int4 plane: prefill {pre_launches} K9, {steps} decode steps "
        f"launch {step}; prefill logits vs the pair (K1) path on the same "
        f"indices: {cfg.n_layers} layers relative L2 {rel:.4g} (<= 2^-6), "
        f"argmax agreement {agree:.4f}")
    ms_step, dev_ms = time_decode(dev, cfg, plane, cache, card,
                                  "int4 plane decode")
    metrics.update(int4_plane_vs_pair_rel_l2=rel,
                   int4_plane_layers_max_err=layers_err,
                   int4_plane_decode_ms_per_step=ms_step,
                   int4_plane_decode_step_graph_ms=dev_ms)
    return launches, metrics


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        + json.dumps({k: round(v['seconds'], 1) for k, v in built.items()}))

    cfg = opt_1b3(dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    cases = {**check_linears(dev, cfg, ["K1"]), "K2": check_k2(dev, g, cfg),
             "K3": check_k3(dev, g, cfg), "K4": check_k4(dev, g, cfg),
             **check_paged(dev, g, cfg)}
    launches, engine, state = run_engine(dev, cfg, smi)
    paged_launches, paged_metrics, pool = run_paged_engine(dev, cfg, smi,
                                                           state)
    launches["K5"] = paged_launches["K5"]
    split_launches, split_metrics = run_split(dev, cfg, state, pool)
    launches.update(split_launches)
    engine.update(paged_metrics, **split_metrics)
    cases.update(check_linears(dev, cfg, ["K6", "K7", "K8", "K9"]))
    layout_launches, layout_metrics = run_layouts(dev, cfg, smi, state)
    launches.update(layout_launches)
    engine.update(layout_metrics)

    rows = []
    for k in (K1, K2, K3, K4, K5, K6, K7, K8, K9, K10, K11, K14, K15):
        cs = cases[k.name]
        # K1 and K6-K9 report one decode layer's four projections (M = 8);
        # the others their first case. Every case is listed under "cases".
        main_cs = [c for c in cs if c["case"].endswith("M=8")] or cs[:1]

        def total(key, main_cs=main_cs):
            vals = [c[key] for c in main_cs]
            return None if any(v is None for v in vals) else sum(vals)

        rows.append(dict(
            name=k.name, route="cuda",
            source=f"sleekit_tpu_torch/csrc/{k.source}",
            replaces=k.replaces.split()[0], launches=launches[k.name],
            max_abs_err=max(c["max_abs_err"] for c in cs),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=main_cs[0]["bound_by"], library_ms=total("library_ms"),
            cases=cs))
    print(json.dumps({"kernels": rows, "engine": engine}))
    print(smi)
    # The run uses one card, whatever the machine holds.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))


if __name__ == "__main__":
    main()
