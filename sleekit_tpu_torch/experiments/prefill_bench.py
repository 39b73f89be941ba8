"""End-to-end prefill time of a packed model (port of the end-to-end
section of ``sleekit_tpu/experiments/prefill_bench.py``).

Times one full-depth prefill of ``--batch`` rows of ``--seq`` random
tokens through ``models.transformer.prefill`` with the kernels, into a
fresh int8 KV cache, as the Engine prefills one length bucket: every
layer's packed linears (K1 for 'pair', K6 for 'pair3x', K7 for 'pair3')
at M = batch * seq, K4, and the int8 head (K2) over every position. The
model is random (seed 0), fused q|k|v, with an int8 head.

On the card the prefills run eagerly between CUDA events (Python issues
the launches, as in the Engine); ``--trace DIR`` records one more prefill
with ``torch.profiler`` into ``DIR/trace.json``, logs the top device ops
and returns the trace's device time by kernel (``trace``: K10, the KV
write, is ``append_kernel``) and its calls of the int8 KV quantizer's
PyTorch ops (``quant_ops``: ``aten::round``, ``aten::amax``, none when
K10 writes the cache). With ``--device cpu`` the plain versions run, timed
by the host clock. The JAX bench's matmul section and its attention-route
A/B are not ported (they come with the experiment CLIs,
``experiments/``).

``--attention`` times K4 (``flash_prefill``) alone instead, in the cases
of :data:`K4_CASES` (``--models`` picks some of them; inputs from a seed,
bf16 or, with ``--dtype f32``, f32 for K4's f32 route; on the card a CUDA
graph of its launches replayed between CUDA events). ``--kv-write``
times K10 alone: over a prompt's rows
(``kv_prefill_write``, the prefill's KV write) in the cases of
:data:`K10_PREFILL_CASES`, beside its plain version (eager), and at one
row a (batch row, head) - K10 and K14, the split route's append at
serving decode, and K10 at B 1, KV 1. Run as a file with another
checkout's package first on ``PYTHONPATH``, either mode times that
checkout's kernels on the same inputs (a package without
``kv_prefill_write`` times only its appends). ``--large-logits`` reads
K4's f32 route at large logits (:data:`K4_LARGE_CASES`): its distance
over the 1e-5 gate from its plain version and from the exact answer (f64),
and the plain version's; run as a file, that of another checkout.

Usage:
  python -m sleekit_tpu_torch.experiments.prefill_bench [--model opt-1.3b]
      [--batch 4] [--seq 512] [--reps 5] [--layout pair|pair3x|pair3]
      [--device cuda|cpu] [--trace DIR]
      [--attention [--models M,...] [--dtype bf16|f32]] [--kv-write]
      [--large-logits]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


# K4's cases, (model, batch rows, prompt length): the main path's
# 256-bucket group (OPT-1.3B: H = KV 32, D 64), BLOOM-560m's ALiBi (H 16,
# D 64) and llama3-8b's GQA at a 1024-token prompt (H 32, KV 8, D 128).
K4_CASES = (("opt-1.3b", 4, 256), ("bloom-560m", 4, 256),
            ("llama3-8b", 1, 1024))

# K4's f32 route at large logits, (head dim, mean of q and k): q and k
# N(mean, 1), v N(0, 1), ALiBi at T 1024 (slopes 0.02-0.4, a bias down to
# -409), B 2, KV 2, G 4; logits about sqrt(D) at mean 1, 9 sqrt(D) at 3.
K4_LARGE_CASES = tuple((D, mean) for D in (64, 80, 128)
                       for mean in (1.0, 3.0))
# The f32 route's gate, elementwise: |got - want| <= 1e-5 + 1e-5 |want|.
K4_F32_GATE = 1e-5

# K10 over a prompt's rows, (label, B, T, H, KV, D): OPT-1.3B's 256-bucket
# group and llama3-8b's GQA at a 1024-token prompt, bf16 K/V sliced out of
# the fused qkv output into an int8 cache of the prompt's rows with bf16
# scales, as the Engine prefills a bucket.
K10_PREFILL_CASES = (("prefill opt-1.3b B=4 T=256", 4, 256, 32, 32, 64),
                     ("prefill llama3-8b B=1 T=1024", 1, 1024, 32, 8, 128))

# K10 at one row a (batch row, KV head), (label, B, KV, positions, with
# K14): OPT-1.3B serving decode and the one-row floor, over APPEND_LAYERS
# layers of an APPEND_ROWS-row int8 cache of head dim APPEND_D (bf16
# scales), the pool's pages APPEND_PAGE rows.
K10_APPEND_CASES = (("T=1 B=8 KV=32", 8, 32, (256, 280), True),
                    ("T=1 B=1 KV=1", 1, 1, (256,), False))
APPEND_LAYERS, APPEND_ROWS, APPEND_D, APPEND_PAGE = 24, 512, 64, 64

# The PyTorch ops of the int8 KV quantizer (``ops/attention.py``
# ``_quant_rows``) that nothing else of a prefill calls.
QUANT_OPS = ("aten::round", "aten::amax")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def k4_inputs(model: str, batch: int, seq: int, device, seed: int = 0,
              dtype=torch.bfloat16):
    """K4's arguments for ``model``'s attention geometry: q (B, T, H, D),
    kT and vT (B, KV, T, D) in ``dtype`` (standard normal f32 draws from
    ``seed``, rounded to bf16 for bf16), the scale, and the model's ALiBi
    slopes (H,) f32 (None without ALiBi)."""
    from sleekit_tpu_torch.models.transformer import alibi_slopes
    from sleekit_tpu_torch.models.zoo import get_config

    cfg = get_config(model)
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape, np.float32)).to(
            device, dtype)

    slopes = (torch.as_tensor(alibi_slopes(H)).to(device)
              if cfg.positional == "alibi" else None)
    return (normal(batch, seq, H, D), normal(batch, KV, seq, D),
            normal(batch, KV, seq, D), 1.0 / D ** 0.5, slopes)


def k4_exact(q, k, v, scale, slopes):
    """K4's function in f64 from the same inputs: q (B, T, H, D), k/v (B,
    KV, T, D), the causal mask and ALiBi as the plain version applies
    them; (B, T, H, D) f64."""
    T, G = q.shape[1], q.shape[2] // k.shape[1]
    s = (q.double().transpose(1, 2)
         @ k.double().repeat_interleave(G, 1).transpose(-1, -2)) * scale
    pos = torch.arange(T, device=q.device)
    dist = (pos[None, :] - pos[:, None]).double()
    if slopes is not None:
        s = s + slopes.double()[:, None, None] * dist
    s = s.masked_fill(dist > 0, float("-inf"))
    return (torch.softmax(s, -1)
            @ v.double().repeat_interleave(G, 1)).transpose(1, 2)


def k4_gate(got, want) -> float:
    """The largest |got - want| over the f32 gate's allowance, 1e-5 +
    1e-5 |want|: at most 1 within the gate."""
    want = want.double()
    return ((got.double() - want).abs()
            / (K4_F32_GATE + K4_F32_GATE * want.abs())).max().item()


def k4_large_logits(device):
    """K4's f32 route in each of :data:`K4_LARGE_CASES` on ``device``: its
    distance over the gate from its plain version and from the exact
    answer, and the plain version's from the exact answer
    (``kernel_plain``, ``kernel_exact``, ``plain_exact``)."""
    from sleekit_tpu_torch.ops.attention import (
        flash_prefill, flash_prefill_plain)

    rows = []
    for D, mean in K4_LARGE_CASES:
        g = torch.Generator().manual_seed(D + int(mean))
        q = torch.randn(2, 1024, 8, D, generator=g).to(device) + mean
        k = torch.randn(2, 2, 1024, D, generator=g).to(device) + mean
        v = torch.randn(2, 2, 1024, D, generator=g).to(device)
        slopes = torch.linspace(0.02, 0.4, 8).to(device)
        got = flash_prefill(q, k, v, D ** -0.5, slopes)
        want = flash_prefill_plain(q, k, v, D ** -0.5, slopes)
        exact = k4_exact(q, k, v, D ** -0.5, slopes)
        rows.append(dict(D=D, mean=mean, kernel_plain=k4_gate(got, want),
                         kernel_exact=k4_gate(got, exact),
                         plain_exact=k4_gate(want, exact)))
        log(f"K4 f32 large logits D={D} mean={mean:g}: over the 1e-5 gate, "
            f"kernel vs plain {rows[-1]['kernel_plain']:.3f}, kernel vs "
            f"exact {rows[-1]['kernel_exact']:.3f}, plain vs exact "
            f"{rows[-1]['plain_exact']:.3f}")
    return rows


def kv_write_bytes(B: int, T: int, KV: int, D: int) -> int:
    """Bytes the prefill's KV write must move: bf16 K/V read, int8 rows,
    bf16 scales and the bf16 dequantized K/V written."""
    return 2 * B * T * KV * (2 * D + D + 2 + 2 * D)


def kv_write_inputs(B: int, T: int, H: int, KV: int, D: int, device,
                    copies: int = 1, seed: int = 0):
    """``copies`` argument sets of the prefill's KV write: k and v (B, T,
    KV, D) bf16 sliced out of a fused qkv output (B, T, (H + 2 KV) D) from
    ``seed``, and a zeroed one-layer int8 cache [k, v, k_scale, v_scale]
    of T rows with bf16 scale planes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(copies):
        qkv = torch.as_tensor(rng.standard_normal(
            (B, T, (H + 2 * KV) * D), np.float32)).to(device, torch.bfloat16)
        k = qkv[..., H * D:(H + KV) * D].reshape(B, T, KV, D)
        v = qkv[..., (H + KV) * D:].reshape(B, T, KV, D)
        cache = [torch.zeros(1, B, KV, T, D, dtype=torch.int8, device=device)
                 for _ in range(2)]
        cache += [torch.zeros(1, B, KV, T, dtype=torch.bfloat16,
                              device=device) for _ in range(2)]
        out.append((k, v, cache))
    return out


def time_kv_write(device, reps: int):
    """K10's times: over a prompt's rows in :data:`K10_PREFILL_CASES`
    (kernel and plain version), then one row a (batch row, head) in
    :data:`K10_APPEND_CASES`, K14's through a table of pages in reverse
    order. Each call writes the next layer's rows."""
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import paged_attention as pa
    from sleekit_tpu_torch.utils.profiling import time_ms

    rows = []

    def record(case, fn, n_args, graph=True):
        ms = time_ms(fn, n_args, device, iters=reps, graph=graph)
        rows.append({"case": case, "ms": ms})
        log(f"{case}: {ms:.4f} ms")

    if hasattr(at, "kv_prefill_write"):
        for label, B, T, H, KV, D in K10_PREFILL_CASES:
            # Copies beyond twice the 50 MB L2, as the layers arrive.
            nbytes = kv_write_bytes(B, T, KV, D)
            sets = kv_write_inputs(B, T, H, KV, D, device,
                                   max(1, -(-100 * 2 ** 20 // nbytes)))
            for name, fn, graph in (
                    ("kernel", at.kv_prefill_write, True),
                    ("plain", at.kv_prefill_write_plain, False)):
                record(f"K10 {label} {name}", lambda i, fn=fn: fn(
                    sets[i][0], sets[i][1], *sets[i][2][:2], 0,
                    *sets[i][2][2:]), len(sets), graph)
            del sets
    rng = np.random.default_rng(1)
    L, S, D, PS = APPEND_LAYERS, APPEND_ROWS, APPEND_D, APPEND_PAGE
    for label, B, KV, positions, with_k14 in K10_APPEND_CASES:
        new = [torch.as_tensor(rng.standard_normal((B, KV, D), np.float32)
                               ).to(device, torch.bfloat16) for _ in "kv"]
        slot = [torch.zeros(L, B, KV, S, D, dtype=torch.int8, device=device)
                for _ in "kv"]
        slot += [torch.zeros(L, B, KV, S, dtype=torch.bfloat16,
                             device=device) for _ in "kv"]
        pages = B * S // PS
        table = (pages - torch.arange(pages)).reshape(B, S // PS).to(
            device, torch.int32)
        pool = [torch.zeros((L, 1 + pages, KV, PS) + x.shape[4:],
                            dtype=x.dtype, device=device) for x in slot]
        for pos in positions:
            record(f"K10 {label} pos {pos}", lambda i, pos=pos: at.kv_append(
                *new, slot[0], slot[1], pos, i, slot[2], slot[3]), L)
            if with_k14:
                record(f"K14 {label} pos {pos}",
                       lambda i, pos=pos: pa.paged_kv_append(
                           *new, pool[0], pool[1], table, pos, i, pool[2],
                           pool[3]), L)
    return rows


def time_attention(device, reps: int, models=None, dtype=torch.bfloat16):
    """K4's time in each of :data:`K4_CASES` on ``device`` (those of
    ``models`` alone, when given) at ``dtype``."""
    from sleekit_tpu_torch.ops.attention import flash_prefill
    from sleekit_tpu_torch.utils.profiling import time_ms

    rows = []
    for model, batch, seq in K4_CASES:
        if models and model not in models:
            continue
        q, k, v, scale, slopes = k4_inputs(model, batch, seq, device,
                                           dtype=dtype)
        ms = time_ms(lambda i: flash_prefill(q, k, v, scale, slopes), 1,
                     device, iters=reps)
        rows.append({"case": f"{model} B={batch} T={seq}", "ms": ms,
                     "dtype": str(dtype).replace("torch.", "")})
        log(f"K4 {rows[-1]['case']} {rows[-1]['dtype']} H={q.shape[2]} "
            f"KV={k.shape[1]} D={q.shape[3]}: {ms:.4f} ms")
    return rows


def time_prefill(cfg, params, tokens: torch.Tensor, reps: int = 5) -> float:
    """Mean ms of one prefill of ``tokens`` (B, T) with the kernels into a
    fresh int8 cache: between CUDA events on the card (eager), by the host
    clock on the CPU."""
    from sleekit_tpu_torch.models.transformer import init_kv_cache, prefill
    from sleekit_tpu_torch.utils.profiling import time_ms

    dev = tokens.device

    def run(_):
        cache = init_kv_cache(cfg, tokens.shape[0], tokens.shape[1],
                              torch.int8, device=dev)
        return prefill(cfg, params, tokens, cache, use_kernel=True)[0]

    return time_ms(run, 1, dev, iters=reps, graph=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="opt-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--layout", default="pair",
                    choices=("pair", "pair3x", "pair3"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="directory for a torch.profiler trace of one "
                    "prefill")
    ap.add_argument("--attention", action="store_true",
                    help="time K4 alone in its cases (K4_CASES)")
    ap.add_argument("--models", default=None,
                    help="with --attention: the K4 cases to time, by model "
                    "(comma-separated; default all)")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"),
                    help="with --attention: q, k and v in bf16 or f32 (K4's "
                    "f32 route)")
    ap.add_argument("--large-logits", action="store_true",
                    help="K4's f32 route at large logits (K4_LARGE_CASES): "
                    "its distances over the 1e-5 gate from its plain "
                    "version and from the exact answer")
    ap.add_argument("--kv-write", action="store_true",
                    help="time K10 alone, over a prompt's rows and at one "
                    "row (and K14)")
    args = ap.parse_args(argv)

    from sleekit_tpu_torch.codebooks import UniformCodebook
    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.quantize import pack_lm_head
    from sleekit_tpu_torch.models.transformer import init_kv_cache, prefill
    from sleekit_tpu_torch.models.zoo import get_config
    from sleekit_tpu_torch.utils.profiling import device_trace

    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU (plain versions)")
    if args.attention:
        models = args.models.split(",") if args.models else None
        dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
        out = {"attention": time_attention(dev, args.reps, models, dtype),
               "device": where}
        print(out)
        return out
    if args.large_logits:
        out = {"large_logits": k4_large_logits(dev), "device": where}
        print(out)
        return out
    if args.kv_write:
        out = {"kv_write": time_kv_write(dev, args.reps), "device": where}
        print(out)
        return out
    cfg = get_config(args.model, dtype=torch.bfloat16)
    nbits = 4 if args.layout == "pair" else 3
    params, _ = random_packed_params(
        cfg, 0, UniformCodebook(2 ** nbits, -1.0, 1.0), fuse_qkv=True,
        layout=args.layout, device=dev)
    params = pack_lm_head(cfg, params, nbits=8)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.seq)),
        dtype=torch.int64, device=dev)
    ms = time_prefill(cfg, params, tokens, args.reps)
    n = args.batch * args.seq
    log(f"prefill {args.model} int{nbits} {args.layout} batch {args.batch} "
        f"x {args.seq}: {ms:.3f} ms = {n / ms * 1e3:.0f} tokens/s on {where}")

    if args.trace:
        cache = init_kv_cache(cfg, args.batch, args.seq, torch.int8,
                              device=dev)
        with device_trace(args.trace) as prof:
            prefill(cfg, params, tokens, cache, use_kernel=True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        by = "self_cuda_time_total" if dev.type == "cuda" \
            else "self_cpu_time_total"
        log(f"  trace of one prefill: {args.trace}/trace.json; top ops by "
            f"{by}:")
        log(prof.key_averages().table(sort_by=by, row_limit=20))
        # Imported here: another checkout's package, run by this file in
        # the --attention and --kv-write modes, may not have it.
        from sleekit_tpu_torch.utils.profiling import trace_summary
        trace = trace_summary(prof)
        trace["quant_ops"] = {op: trace["ops"].get(op, 0)
                              for op in QUANT_OPS}
        del trace["ops"]
        log(f"  device time {trace['device_ms']:.3f} ms; by kernel: "
            f"{trace['kernels']}; quantizer ops {trace['quant_ops']}")
    out = {"ms": ms, "tokens": n, "tokens_per_s": n / ms * 1e3,
           "layout": args.layout, "device": where}
    if args.trace:
        out["trace"] = trace
    print(out)
    return out


if __name__ == "__main__":
    main()
