"""Split the per-step decode cost (port of
``sleekit_tpu/experiments/profile_decode.py``).

Times ``--steps`` steps of progressively stripped decode variants, at
the last ``steps`` positions of a ``--ctx``-row cache (so attention reads
about ``ctx`` rows, as a served step at that context does), so the step
splits into weights, attention + KV, unembed and the rest:

* ``full`` - the serving decode step (``decode_step``, greedy feedback);
* ``no_unembed`` - embed and all layers, no final norm and head;
* ``linears_only`` - each layer's packed linears on a fixed input, no norm
  prologue (the weight stream);
* ``attn_only`` - each layer's ``decode_attention`` (append and attend, by
  the route the ``ops/attention.py`` knobs select) on a fixed input.

``unembed`` (full - no_unembed) and ``residual`` (no_unembed -
linears_only - attn_only: norms, embedding, glue) are derived; a negative
residual means the variants did not time the same work, and is logged as
such. On the card
each variant's steps are captured in one CUDA graph and replayed between
CUDA events (device time), and run eagerly as well (host time, with
Python issuing every launch); ``--trace DIR`` records a ``torch.profiler``
trace of the first four eager ``full`` steps into ``DIR/trace.json`` and
logs the top device ops. With ``--device cpu`` the plain versions run,
timed by the host clock. The port keeps a per-layer list of weights, so
the JAX bench's stacked-tree split and merge are a loop over
``params["layers"]``.

Usage:
  python -m sleekit_tpu_torch.experiments.profile_decode [--model opt-1.3b]
      [--batch 8] [--steps 64] [--ctx 256] [--nbits 4] [--dense]
      [--layout pair|plane] [--codebook uniform|nf4] [--kv int8|bf16]
      [--no-fuse]
      [--variants full,no_unembed,linears_only,attn_only]
      [--device cuda|cpu] [--trace DIR]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


# Eager full steps the --trace run records (a few keep the trace small).
TRACE_STEPS = 4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="opt-1.3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--ctx", type=int, default=256)
    ap.add_argument("--nbits", type=int, default=4)
    ap.add_argument("--dense", action="store_true",
                    help="profile the bf16 dense path instead of packed")
    ap.add_argument("--layout", default="pair",
                    help="packed layout (pair/plane), default = serving "
                    "default")
    ap.add_argument("--codebook", default="uniform",
                    choices=("uniform", "nf4"),
                    help="packed models: the uniform grid of --nbits "
                    "(K1, or K9 over 'plane') or the NF4 table (4 bits, "
                    "'plane' only: K8)")
    ap.add_argument("--kv", default="int8", choices=("bf16", "int8"),
                    help="KV-cache dtype (packed models; dense: bf16)")
    ap.add_argument("--no-fuse", action="store_true",
                    help="skip the serving-time q|k|v fusion")
    ap.add_argument("--variants",
                    default="full,no_unembed,linears_only,attn_only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="directory for a torch.profiler trace of 'full'")
    args = ap.parse_args(argv)

    from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook
    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.models import transformer as tr
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.quantize import pack_lm_head
    from sleekit_tpu_torch.models.zoo import get_config
    from sleekit_tpu_torch.ops.attention import decode_attention
    from sleekit_tpu_torch.utils.profiling import device_trace, time_ms

    dev = resolve_device(args.device)
    cfg = get_config(args.model, dtype=torch.bfloat16)
    variants = args.variants.split(",")
    b, steps, ctx = args.batch, args.steps, args.ctx
    if steps > ctx:
        raise ValueError(f"--steps {steps} must not exceed --ctx {ctx}")
    pos0 = ctx - steps
    kv_dtype = torch.bfloat16 if args.dense or args.kv == "bf16" \
        else torch.int8
    if args.codebook == "nf4" and (args.nbits != 4 or args.layout != "plane"):
        raise ValueError("--codebook nf4 takes --nbits 4 --layout plane")
    codebook = Codebook.nf4() if args.codebook == "nf4" \
        else UniformCodebook(2 ** args.nbits, -1.0, 1.0)
    name = "nf4" if args.codebook == "nf4" else f"int{args.nbits}"
    tag = "bf16 dense" if args.dense else f"{name} packed ({args.layout})"
    params = None
    if {"full", "no_unembed", "linears_only"} & set(variants):
        if args.dense:
            params = tr.init_params(cfg, 0, device=dev)
        else:
            params, _ = random_packed_params(
                cfg, 0, codebook, fuse_qkv=not args.no_fuse,
                layout=args.layout, device=dev)
            params = pack_lm_head(cfg, params, nbits=8)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU (plain versions)")
    log(f"profile: {args.model} {tag} batch={b} steps={steps} at positions "
        f"{pos0}-{pos0 + steps - 1} ctx={ctx} kv={kv_dtype} on {where}")

    def fresh_cache():
        return tr.init_kv_cache(cfg, b, ctx, dtype=kv_dtype, device=dev)

    x0 = torch.ones((b, 1, cfg.d_model), dtype=cfg.dtype, device=dev)
    last = torch.zeros(b, dtype=torch.int32, device=dev)
    slopes = tr._slopes(cfg, dev)
    hd, kv = cfg.head_dim, cfg.kv_heads

    def full(cache, pos):
        logits, _ = tr.decode_step(cfg, params, last[:, None], cache, pos)
        last.copy_(torch.argmax(logits, dim=-1))

    def no_unembed(cache, pos):
        positions = torch.full((b, 1), pos, dtype=torch.long, device=dev)
        x = tr._embed(cfg, params, last[:, None], positions, True)
        for i, layer in enumerate(params["layers"]):
            x = tr._block(cfg, layer, x, positions, ("decode", cache, pos, i),
                          slopes, True)
        last.add_(1).remainder_(cfg.vocab_size)

    def lin(p, x):  # the kernel wrappers: plain versions on the CPU
        return tr.apply_linear(p, x, use_kernel=True)

    def linears_only(cache, pos):
        x = x0
        for layer in params["layers"]:
            a, m = layer["attn"], layer["mlp"]
            if "qkv" in a:  # serving-time fused projections
                h = lin(a["qkv"], x)[..., :cfg.d_model]
            else:
                h = lin(a["q"], x) + lin(a["k"], x).mean() \
                    + lin(a["v"], x).mean()
            h = lin(a["o"], h)
            if "gate_up" in m:
                gu = lin(m["gate_up"], h)
                half = gu.shape[-1] // 2
                h = lin(m["down"], gu[..., :half] * gu[..., half:])
            elif "gate" in m:
                h = lin(m["down"], lin(m["gate"], h) * lin(m["up"], h))
            else:
                h = lin(m["fc2"], lin(m["fc1"], h))
            x = x + 1e-6 * h

    def attn_only(cache, pos):
        x = x0
        for lidx in range(cfg.n_layers):
            q = x.reshape(b, cfg.n_heads, hd)
            k = x[:, 0, :kv * hd].reshape(b, kv, hd).contiguous()
            out = decode_attention(q, k, k, cache["k"], cache["v"], pos, lidx,
                                   k_scale=cache.get("k_scale"),
                                   v_scale=cache.get("v_scale"))[0]
            x = x + out.reshape(b, 1, cfg.d_model)

    fns = {"full": full, "no_unembed": no_unembed,
           "linears_only": linears_only, "attn_only": attn_only}
    results, eager = {}, {}
    for name in variants:
        fn = fns[name]
        cache = fresh_cache()
        # The steps at positions pos0 .. pos0+steps-1, one graph replay (or
        # host loop) per measurement; then the same steps issued eagerly.
        results[name] = time_ms(lambda i: fn(cache, pos0 + i), steps, dev,
                                iters=steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                fn(cache, pos0 + i)
            torch.cuda.synchronize()
            eager[name] = (time.perf_counter() - t0) / steps * 1e3
        log(f"  {name}: {results[name]:.3f} ms/step"
            + (f" (eager {eager[name]:.3f})" if name in eager else ""))

    if args.trace and "full" in variants:
        cache = fresh_cache()
        n = min(steps, TRACE_STEPS)
        with device_trace(args.trace) as prof:
            for i in range(n):
                full(cache, pos0 + i)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        by = "self_cuda_time_total" if dev.type == "cuda" \
            else "self_cpu_time_total"
        log(f"  trace of {n} eager full steps: {args.trace}/trace.json; "
            f"top ops by {by}:")
        log(prof.key_averages().table(sort_by=by, row_limit=12))

    log("")
    for k, v in results.items():
        log(f"  {k:>14}: {v:7.3f} ms/step")
    if "full" in results and "no_unembed" in results:
        results["unembed"] = results["full"] - results["no_unembed"]
        log(f"  {'unembed':>14}: {results['unembed']:7.3f} ms/step (derived)")
    if {"no_unembed", "linears_only", "attn_only"} <= results.keys():
        results["residual"] = (results["no_unembed"]
                               - results["linears_only"]
                               - results["attn_only"])
        log(f"  {'residual':>14}: {results['residual']:7.3f} ms/step "
            f"(norms/embed/glue)")
        if results["residual"] < 0:
            log("  WARNING: the residual is negative: the variants did not "
                "time the same work (a variant on other kernels, or on the "
                "plain versions?)")
    out = {"ms_per_step": results, "eager_ms_per_step": eager,
           "positions": [pos0, pos0 + steps - 1], "device": where}
    print(out)
    return out


if __name__ == "__main__":
    main()
