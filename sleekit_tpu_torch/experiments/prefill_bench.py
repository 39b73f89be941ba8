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
with ``torch.profiler`` into ``DIR/trace.json`` and logs the top device
ops. With ``--device cpu`` the plain versions run, timed by the host
clock. The JAX bench's matmul section and its attention-route A/B are
not ported (ROADMAP queue 1, item 8).

``--attention`` times K4 (``flash_prefill``) alone instead, in the cases
of :data:`K4_CASES` (``--models`` picks some of them; bf16 inputs from a
seed; on the card a CUDA graph of its launches replayed between CUDA
events). Run as a file with another checkout's package first on
``PYTHONPATH``, it times that checkout's K4 on the same inputs.

Usage:
  python -m sleekit_tpu_torch.experiments.prefill_bench [--model opt-1.3b]
      [--batch 4] [--seq 512] [--reps 5] [--layout pair|pair3x|pair3]
      [--device cuda|cpu] [--trace DIR] [--attention [--models M,...]]
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


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def k4_inputs(model: str, batch: int, seq: int, device, seed: int = 0):
    """K4's arguments for ``model``'s attention geometry: q (B, T, H, D),
    kT and vT (B, KV, T, D) in bf16 from ``seed``, the scale, and the
    model's ALiBi slopes (H,) f32 (None without ALiBi)."""
    from sleekit_tpu_torch.models.transformer import alibi_slopes
    from sleekit_tpu_torch.models.zoo import get_config

    cfg = get_config(model)
    H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape, np.float32)).to(
            device, torch.bfloat16)

    slopes = (torch.as_tensor(alibi_slopes(H)).to(device)
              if cfg.positional == "alibi" else None)
    return (normal(batch, seq, H, D), normal(batch, KV, seq, D),
            normal(batch, KV, seq, D), 1.0 / D ** 0.5, slopes)


def time_attention(device, reps: int, models=None):
    """K4's time in each of :data:`K4_CASES` on ``device`` (those of
    ``models`` alone, when given)."""
    from sleekit_tpu_torch.ops.attention import flash_prefill
    from sleekit_tpu_torch.utils.profiling import time_ms

    rows = []
    for model, batch, seq in K4_CASES:
        if models and model not in models:
            continue
        q, k, v, scale, slopes = k4_inputs(model, batch, seq, device)
        ms = time_ms(lambda i: flash_prefill(q, k, v, scale, slopes), 1,
                     device, iters=reps)
        rows.append({"case": f"{model} B={batch} T={seq}", "ms": ms})
        log(f"K4 {rows[-1]['case']} H={q.shape[2]} KV={k.shape[1]} "
            f"D={q.shape[3]}: {ms:.4f} ms")
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
        out = {"attention": time_attention(dev, args.reps, models),
               "device": where}
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

    out = {"ms": ms, "tokens": n, "tokens_per_s": n / ms * 1e3,
           "layout": args.layout, "device": where}
    print(out)
    return out


if __name__ == "__main__":
    main()
