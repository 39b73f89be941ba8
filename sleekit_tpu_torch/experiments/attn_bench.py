"""Microbenchmark decode attention against its bytes bound (port of
``sleekit_tpu/experiments/attn_bench.py``).

Per layer, one ``kv_append`` (K10) and one ``flash_decode`` over an
(L, B, KV, S, D) cache - int8 with f32 scale planes, or bf16 - as a model
geometry's decode step gives them. The flash decode runs the kernel the
module knobs of ``ops/attention.py`` select: K11, K12
(``FLASH_MHA_MODE = 'ew'``, MHA only) or K13 (``FLASH_BATCH_FOLD``). The
JAX bench sweeps the TPU kernel's KV fold factor (``--chunks``); the CUDA
kernels have one schedule, so the step is timed once.

On the card, ``--iters`` steps of all L layers (positions S/2, S/2 + 1,
... wrapping at S) are captured in one CUDA graph and replayed between
CUDA events: the time per step is the device's. A graph replays every
launch, so no carried perturbation is needed to keep a loop from being
hoisted, as in the JAX bench's scan. With ``--device cpu`` the plain
versions run, timed by the host clock.

Usage:
  python -m sleekit_tpu_torch.experiments.attn_bench [--model opt-1.3b]
      [--batch 8] [--ctx 256] [--kv int8|bf16] [--iters 128]
      [--parts both|decode|append] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="opt-1.3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ctx", type=int, default=256)
    ap.add_argument("--kv", default="int8", choices=("bf16", "int8"))
    ap.add_argument("--iters", type=int, default=128)
    ap.add_argument("--parts", default="both",
                    choices=("both", "decode", "append"),
                    help="which kernels to include per layer step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.models.zoo import get_config
    from sleekit_tpu_torch.ops import attention as attn
    from sleekit_tpu_torch.utils.profiling import time_ms

    dev = resolve_device(args.device)
    cfg = get_config(args.model, dtype=torch.bfloat16)
    b, S = args.batch, args.ctx
    L, KV, D = cfg.n_layers, cfg.kv_heads, cfg.head_dim
    G = cfg.n_heads // KV
    quant = args.kv == "int8"
    kv_bytes = 2 * L * b * KV * S * D * (1 if quant else 2)

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, cfg.n_heads, D),
                                             np.float32)).to(dev,
                                                             torch.bfloat16)
    kn = torch.from_numpy(rng.standard_normal((b, KV, D), np.float32)).to(
        dev, torch.bfloat16)
    shape = (L, b, KV, S, D)
    if quant:
        cache = [torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.zeros(shape, dtype=torch.int8, device=dev),
                 torch.ones(shape[:-1], device=dev),
                 torch.ones(shape[:-1], device=dev)]
    else:
        cache = [torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                 torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                 None, None]
    ck, cv, ks, vs = cache
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU (plain versions)")
    kernel = attn.decode_route(q, ck)[0].name
    log(f"attn bench: {args.model} L={L} B={b} KV={KV} G={G} S={S} D={D} "
        f"kv={args.kv}, flash decode {kernel}; "
        f"cache bytes/step {kv_bytes / 1e6:.0f} MB on {where}")
    do_append = args.parts in ("both", "append")
    do_decode = args.parts in ("both", "decode")
    scale = 1.0 / D ** 0.5

    def step(i):
        pos = (S // 2 + i) % S
        for lidx in range(L):
            if do_append:
                attn.kv_append(kn, kn, ck, cv, pos, lidx, ks, vs)
            if do_decode:
                attn.flash_decode(q, ck, cv, pos, lidx, scale, None, ks, vs)

    step_ms = time_ms(step, S, dev, iters=args.iters)
    gbs = kv_bytes / (step_ms * 1e-3) / 1e9
    log(f"  {step_ms:7.3f} ms/step ({step_ms / L * 1e3:5.1f} us/layer, "
        f"{gbs:6.1f} GB/s eff)")
    results = {"kernel": kernel, "ms_per_step": step_ms,
               "us_per_layer": step_ms / L * 1e3, "gb_per_s": gbs}
    print(results)
    return results


if __name__ == "__main__":
    main()
