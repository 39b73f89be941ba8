"""Serve a packed checkpoint: batch generation through the engine (port of
``sleekit_tpu/experiments/serve_cli.py``).

  python -m sleekit_tpu_torch.experiments.serve_cli ckpt/ --model opt-125m \\
      --prompts prompts.npy --max-new-tokens 32 [--temperature 0.7] \\
      [--kv f32|bf16|int8] [--paged] [--device cuda|cpu]

Prompts: .npy object/int32 array of token id sequences, or (with
--random N) N random prompts for smoke/throughput runs. Prints one line
per completion plus aggregate tokens/s for a cold run and a steady run of
the same requests. It runs on the CUDA device unless ``--device cpu`` is
given. Tensor-parallel (``--tp``) and replica (``--replicas``) serving
are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve a packed checkpoint")
    parser.add_argument("ckpt", type=str)
    parser.add_argument("--model", type=str, default="tiny")
    parser.add_argument("--prompts", type=str, default=None,
                        help=".npy array of int32 token prompts")
    parser.add_argument("--random", type=int, default=0,
                        help="Generate N random prompts instead")
    parser.add_argument("--prompt-len", type=int, default=16)
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--max-seq-len", type=int, default=512)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kv", type=str, default="f32",
                        choices=["f32", "bf16", "int8"],
                        help="KV-cache dtype (int8 = per-token scales)")
    parser.add_argument("--paged", action="store_true",
                        help="paged KV pool instead of dense slot cache")
    parser.add_argument("--page-size", type=int, default=64)
    parser.add_argument("--total-pages", type=int, default=None)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ways (not ported yet)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="independent replica engines (not ported yet)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.tp > 1 or args.replicas > 1:
        raise NotImplementedError(
            "--tp and --replicas are not ported yet (ROADMAP, modules to "
            "port: parallel/ and serve/router.py)")

    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.models.zoo import get_config
    from sleekit_tpu_torch.serve.checkpoint import load_packed_params
    from sleekit_tpu_torch.serve.engine import Engine, Request

    dev = resolve_device(args.device)
    cfg = get_config(args.model)
    params, meta = load_packed_params(args.ckpt, cfg=cfg, device=dev)
    print(f"loaded {args.ckpt} (meta: {meta})")

    rng = np.random.RandomState(args.seed)
    if args.prompts:
        arr = np.load(args.prompts, allow_pickle=True)
        prompts = [np.asarray(p, np.int32) for p in arr]
    else:
        n = args.random or 4
        prompts = [rng.randint(0, cfg.vocab_size,
                               (args.prompt_len,)).astype(np.int32)
                   for _ in range(n)]

    cache_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                   "int8": torch.int8}[args.kv]
    engine = Engine(cfg, params, max_slots=args.slots,
                    max_seq_len=args.max_seq_len, seed=args.seed,
                    cache_dtype=cache_dtype, paged=args.paged,
                    page_size=args.page_size, total_pages=args.total_pages,
                    device=dev)

    def mk_reqs():
        return [Request(prompt=p, max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature) for p in prompts]

    def timed_run():
        t0 = time.perf_counter()
        comps = engine.run(mk_reqs())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        return comps, dt, sum(len(c.new_tokens) for c in comps)

    cold, cold_s, cold_n = timed_run()
    for c in cold:
        print(f"[{c.request_id}] +{len(c.new_tokens)} tokens "
              f"({c.finish_reason}): {c.new_tokens.tolist()}")
    what = ("includes the kernels' first launches and the decode graph's "
            "captures" if engine.graphs else "the first run")
    print(f"{cold_n} tokens in {cold_s:.2f}s = {cold_n / cold_s:.1f} "
          f"tokens/s (cold: {what})")
    # Steady state: the same requests again, every decode graph captured.
    steady, steady_s, steady_n = timed_run()
    print(f"steady state: {steady_n} tokens in {steady_s:.2f}s = "
          f"{steady_n / steady_s:.1f} tokens/s")
    return dict(engine=engine, cold=cold, steady=steady, cold_s=cold_s,
                steady_s=steady_s, cold_tokens_per_s=cold_n / cold_s,
                steady_tokens_per_s=steady_n / steady_s)


if __name__ == "__main__":
    main()
