"""Microbenchmark the dequant-matmul kernels against their bytes bound
(port of ``sleekit_tpu/experiments/kernel_bench.py``).

Times y = x @ deq(W) for the decode-shape matmuls of a model geometry
(M = batch, K x N from the layer shapes) per layout: ``pair`` (K1),
``plane`` (K9 for a uniform codebook, K8 for a table), ``int8`` (K2, the
layout of a packed head, 8-bit uniform codebook whatever ``--nbits``
says) and ``dense`` (one bf16 ``torch.matmul``, the yardstick), and
reports the weight bytes each streams per call as GB/s and as a share of
the H100's 3.35 TB/s.

On the card the calls are captured in a CUDA graph and replayed between
CUDA events, cycling over enough copies of the weight to exceed twice the
50 MB L2, so every call reads its weight from device memory as decode
does layer after layer. The JAX bench's ``pair@...`` variants and
``--block-n`` tune TPU schedules and have no counterpart here. With
``--device cpu`` the plain versions run, timed by the host clock.

Usage:
  python -m sleekit_tpu_torch.experiments.kernel_bench [--nbits 4] [--m 8]
      [--shapes 2048x6144,2048x2048,2048x8192,8192x2048] [--iters 256]
      [--variants pair,plane,int8,dense] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
L2_BYTES = 50 * 2 ** 20


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nbits", type=int, default=4)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--shapes",
                    default="2048x6144,2048x2048,2048x8192,8192x2048")
    ap.add_argument("--iters", type=int, default=256)
    ap.add_argument("--variants", default="pair,plane,dense")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from sleekit_tpu_torch.codebooks import UniformCodebook
    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.models.fake_quant import random_packed_linear
    from sleekit_tpu_torch.ops.dequant_matmul import quantized_matmul
    from sleekit_tpu_torch.utils.profiling import time_ms

    dev = resolve_device(args.device)
    cb = UniformCodebook(2 ** args.nbits, -1.0, 1.0)
    cb8 = UniformCodebook(256, -1.0, 1.0)
    shapes = [tuple(map(int, s.split("x"))) for s in args.shapes.split(",")]
    variants = args.variants.split(",")
    for v in variants:
        if v not in ("pair", "plane", "int8", "dense"):
            raise ValueError(f"variant {v!r}: the port times 'pair', "
                             "'plane', 'int8' and 'dense' (the TPU tuning "
                             "variants pair@... are TPU schedules)")
    m = args.m
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU (plain versions)")
    log(f"kernel bench: int{args.nbits} M={m} on {where}")
    rng = np.random.default_rng(0)

    results = []
    for (k, n) in shapes:
        x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(
            dev, torch.bfloat16)
        for variant in variants:
            if variant == "dense":
                w = torch.from_numpy(rng.standard_normal((k, n), np.float32)
                                     ).to(dev, torch.bfloat16)
                nbytes = k * n * 2
                copies = [w] + [w.clone() for _ in range(
                    _copies(nbytes, dev) - 1)]

                def fn(i, copies=copies):
                    return torch.matmul(x, copies[i])
            else:
                p = random_packed_linear(
                    1, k, n, cb8 if variant == "int8" else cb,
                    layout=variant, device=dev)
                nbytes = p.packed.numel() * p.packed.element_size()
                copies = [p] + [dataclasses.replace(p, packed=p.packed.clone())
                                for _ in range(_copies(nbytes, dev) - 1)]

                def fn(i, copies=copies):
                    return quantized_matmul(x, copies[i])
            us = time_ms(fn, len(copies), dev, iters=args.iters) * 1e3
            gbs = nbytes / (us * 1e-6) / 1e9
            results.append((k, n, variant, us, gbs, nbytes))
            share = (f"{gbs * 1e9 / HBM_BYTES_PER_S:6.1%} of 3.35 TB/s, "
                     if dev.type == "cuda" else "")
            log(f"  {k}x{n} {variant:>6}: {us:8.1f} us  {gbs:7.1f} GB/s "
                f"({share}bytes {nbytes / 1e6:.1f} MB, {len(copies)} "
                f"copies)")
            del copies

    log("")
    log(f"{'shape':>12} {'variant':>8} {'us':>9} {'GB/s':>8}")
    for k, n, v, us, gbs, nb in results:
        log(f"{k}x{n:>6} {v:>8} {us:9.1f} {gbs:8.1f}")
    out = [(f"{k}x{n}", v, round(us, 1), round(gbs, 1))
           for k, n, v, us, gbs, nb in results]
    print(out)
    return out


def _copies(nbytes: int, dev: torch.device) -> int:
    """Weight copies to cycle over so that their total exceeds twice L2
    (one on the CPU)."""
    if dev.type != "cuda":
        return 1
    return max(1, min(32, math.ceil(2 * L2_BYTES / nbytes)))


if __name__ == "__main__":
    main()
