"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels (K1-K4) from ``sleekit_tpu_torch/csrc``;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes OPT-1.3B serving gives it, and times the kernel, the plain
   version and one PyTorch library call computing the same function (a
   yardstick the port never calls) with CUDA events;
3. serves 8 greedy requests of 32 new tokens through the port's slot
   Engine with OPT-1.3B at full width and depth (random int4 'pair'
   weights from a seed, fused q|k|v, int8 head, int8 KV cache with bf16
   scales), checks that every kernel launched and the launches of one
   decode step, checks the prefill logits against the kernels' plain
   versions on the card (bf16 tolerance through the first layer, relative
   L2 through all of them), and times batch-8 decode;
4. prints the kernels line, the card's name and power limit, and, last,
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
from sleekit_tpu_torch.models.eval import decode_scan  # noqa: E402
from sleekit_tpu_torch.models.fake_quant import random_packed_params  # noqa: E402
from sleekit_tpu_torch.models.quantize import pack_lm_head  # noqa: E402
from sleekit_tpu_torch.models.transformer import (  # noqa: E402
    decode_step, init_kv_cache, prefill)
from sleekit_tpu_torch.models.zoo import opt_1b3  # noqa: E402
from sleekit_tpu_torch.ops import attention as attn  # noqa: E402
from sleekit_tpu_torch.ops import dequant_matmul as dm  # noqa: E402
from sleekit_tpu_torch.ops.attention import K3, K4  # noqa: E402
from sleekit_tpu_torch.ops.dequant_matmul import K1, K2  # noqa: E402
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


def check_k1(dev, g, cfg):
    """K1 on the four projections of a layer with their prologues, at
    decode M = 8 and at the largest prefill M (4 rows of the 256 bucket)."""
    d, ff = cfg.d_model, cfg.d_ff
    shapes = [("qkv", d, 3 * d, "layernorm", False),
              ("o", d, d, None, True),
              ("fc1", d, ff, "layernorm", False),
              ("fc2", ff, d, "relu", True)]
    cases = []
    for m in (8, 1024):
        for name, K, N, pre, res in shapes:
            kw_rows = -(-K // 256) * 32        # 4-bit pair tiles: 256 rows
            n_copy = copies_for(kw_rows * N * 4 + K * N * 2)
            words = [torch.randint(-2 ** 31, 2 ** 31, (kw_rows, N),
                                   dtype=torch.int64, generator=g
                                   ).to(torch.int32).to(dev)
                     for _ in range(n_copy)]
            scale = (0.02 + 0.002 * torch.rand(N, generator=g)).to(dev)
            bias = (0.01 * torch.randn(N, generator=g)).to(dev)
            x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
            kw = dict(nbits=4, k=K, a_aff=2.0 / 15 * 16, b_aff=-1.0 - 32 / 15,
                      pre=pre, eps=1e-5)
            if pre == "layernorm":
                kw["ln_scale"] = torch.ones(K, dtype=torch.bfloat16,
                                            device=dev)
                kw["ln_bias"] = torch.zeros(K, dtype=torch.bfloat16,
                                            device=dev)
            if res:
                kw["residual"] = torch.randn(m, N, generator=g).to(
                    dev, torch.bfloat16)
            got = dm.pair_matmul(x, words[0], scale, bias, **kw)
            want = dm.pair_matmul_plain(x, words[0], scale, bias, **kw)
            torch.cuda.synchronize()
            err = bf16_check(got, want, f"K1 {name} M={m}")
            ms = cuda_ms(lambda i: dm.pair_matmul(x, words[i], scale, bias,
                                                  **kw), n_copy)
            plain_ms = cuda_ms(lambda i: dm.pair_matmul_plain(
                x, words[i], scale, bias, **kw), n_copy, iters=5, warmup=1,
                graph=False)
            # yardstick: the same product on a pre-dequantized bf16 weight
            xp = dm._prologue_plain(x, pre, kw.get("ln_scale"),
                                    kw.get("ln_bias"), 1e-5, K)
            wdeq = [(1.0 + dm.unpack_indices(w, 4, K, "pair").float() / 16
                     ).to(torch.bfloat16) for w in words]
            lib_ms = cuda_ms(lambda i: torch.matmul(xp, wdeq[i]), n_copy)
            del wdeq
            nbytes = (x.numel() * 2 + kw_rows * N * 4 + 2 * N * 4 + m * N * 2
                      + (2 * K * 2 if pre == "layernorm" else 0)
                      + (m * N * 2 if res else 0))
            b_ms, b_by = bound(nbytes, 2.0 * m * K * N)
            cases.append(dict(case=f"{name} M={m}", max_abs_err=err, ms=ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
            log(f"K1 {name:4s} M={m:5d} K={K} N={N}: err {err:.3g} | "
                f"kernel {ms:.4f} ms plain {plain_ms:.3f} ms matmul "
                f"{lib_ms:.4f} ms bound {b_ms:.4f} ms ({b_by})")
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


# ---- phase 3: the Engine ------------------------------------------------------


PROMPT_LENS = [12, 30, 50, 100, 140, 200, 250, 20]   # buckets 16..256
NEW_TOKENS = 32


def run_engine(dev, cfg, card: str):
    """``card``: the card's name and power limit, printed beside the
    decode rate."""
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
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]
    engine = Engine(cfg, params, max_slots=8, max_seq_len=512,
                    cache_dtype=torch.int8, device=dev, use_kernel=True)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    comps = engine.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in (K1, K2, K3, K4)}
    log(f"Engine: 8 requests x {NEW_TOKENS} tokens in {run_s:.2f} s; "
        f"launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    for c, p in zip(comps, prompts):
        if (len(c.new_tokens) != NEW_TOKENS or c.finish_reason != "length"
                or not ((c.new_tokens >= 0)
                        & (c.new_tokens < cfg.vocab_size)).all()
                or not np.array_equal(c.tokens[:len(p)], p)):
            raise AssertionError(f"bad completion {c.request_id}")

    # One decode step through the public entry point: 4 K1 per layer
    # (qkv, o, fc1, fc2), one K2 head, one K3 per layer.
    kernels.reset_launch_counts()
    tok = torch.zeros((8, 1), dtype=torch.int64, device=dev)
    logits, _ = decode_step(cfg, params, tok, engine.cache, 300,
                            use_kernel=True)
    torch.cuda.synchronize()
    step = {k.name: k.launches for k in (K1, K2, K3, K4)}
    if step != {"K1": 4 * cfg.n_layers, "K2": 1, "K3": cfg.n_layers,
                "K4": 0}:
        raise AssertionError(f"one decode step launched {step}")
    if logits.shape != (8, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("decode logits not finite (8, vocab)")
    log(f"one decode step launches {step}")

    # The 256-bucket admission group (3 prompts in 4 rows), prefilled
    # through the Engine's prefill entry point with the kernels and with
    # their plain versions on the card (use_kernel=False). Through the
    # first layer and the head, the logits agree within the bf16
    # tolerance. Through all layers they cannot: the two sum in different
    # orders, each op's outputs then differ by one bf16 step in about 1e-4
    # to 1e-3 of their elements, and the next wide product spreads that to
    # most elements, layer after layer (42% of the logits differ after one
    # layer, 86% after 24, relative L2 3e-3 -> 1.25e-2, H100 700 W, this
    # script's data). Full depth is held to a relative L2 of at most 2^-6.
    group = [p for p in prompts if 128 < len(p) <= 256]
    toks = np.zeros((4, 256), np.int32)
    for r, p in enumerate(group):
        toks[r, :len(p)] = p
    toks = torch.as_tensor(toks, dtype=torch.int64, device=dev)

    def group_logits(n_layers, use_kernel):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        cache = init_kv_cache(c, 4, 256, torch.int8, device=dev)
        logits, _ = prefill(c, dict(params, layers=params["layers"][:n_layers]),
                            toks, cache, use_kernel=use_kernel)
        return logits[:len(group)].float()

    err1 = bf16_check(group_logits(1, True), group_logits(1, False),
                      "prefill logits through layer 1, kernels vs plain")
    got, want = group_logits(cfg.n_layers, True), group_logits(cfg.n_layers,
                                                               False)
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    if not rel <= 2 ** -6 or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits through {cfg.n_layers} layers: "
                             f"relative L2 {rel:.4g} over 2^-6")
    log(f"prefill logits (3 prompts, bucket 256), kernels vs plain versions: "
        f"layer 1 max |err| {err1:.4g} (bf16 tolerance); {cfg.n_layers} "
        f"layers relative L2 {rel:.4g} (<= 2^-6), max |err| "
        f"{(got - want).abs().max().item():.4g}, argmax agreement {agree:.4f}")

    # Batch-8 greedy decode rate over the cache the Engine filled (eager:
    # Python issues every launch), and one decode step's device time (the
    # same step captured in a CUDA graph and replayed).
    last = torch.zeros(8, dtype=torch.int32, device=dev)
    decode_scan(cfg, params, engine.cache, last, 256, 4, use_kernel=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 32
    decode_scan(cfg, params, engine.cache, last, 256, steps, use_kernel=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tok_s = 8 * steps / dt
    dev_ms = cuda_ms(lambda i: decode_step(cfg, params, tok, engine.cache,
                                           288, use_kernel=True), 1, iters=4)
    log(f"decode: batch 8, ctx 256-288, {steps} steps: "
        f"{dt / steps * 1e3:.3f} ms/step, {tok_s:.1f} tokens/s; one step "
        f"replayed as a CUDA graph: {dev_ms:.3f} ms ({card})")
    return launches, dict(engine_run_s=run_s, decode_ms_per_step=dt / steps
                          * 1e3, decode_tokens_per_s=tok_s,
                          decode_step_graph_ms=dev_ms,
                          prefill_layer1_max_err=err1,
                          prefill_full_rel_l2=rel,
                          prefill_full_argmax_agree=agree)


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
    cases = {"K1": check_k1(dev, g, cfg), "K2": check_k2(dev, g, cfg),
             "K3": check_k3(dev, g, cfg), "K4": check_k4(dev, g, cfg)}
    launches, engine = run_engine(dev, cfg, smi)

    rows = []
    for k in (K1, K2, K3, K4):
        cs = cases[k.name]
        # K1 reports one decode layer's four projections (M = 8); the
        # others their first case. Every case is listed under "cases".
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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
