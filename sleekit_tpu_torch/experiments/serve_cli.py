"""Serve a packed checkpoint: batch generation through the engine (port of
``sleekit_tpu/experiments/serve_cli.py``).

  python -m sleekit_tpu_torch.experiments.serve_cli ckpt/ --model opt-125m \\
      --prompts prompts.npy --max-new-tokens 32 [--temperature 0.7] \\
      [--kv f32|bf16|int8] [--paged] [--device cuda|cpu]

Prompts: .npy object/int32 array of token id sequences, or (with
--random N) N random prompts for smoke/throughput runs. Prints one line
per completion plus aggregate tokens/s for a cold run and a steady run of
the same requests. It runs on the CUDA device unless ``--device cpu`` is
given.

``--tp N`` serves tensor-parallel over N ranks (``parallel/``): run alone,
the command starts its N ranks itself, one a CUDA device (NCCL; it raises
with fewer devices than N) or, with ``--device cpu``, N CPU processes
(gloo); under ``torchrun --nproc-per-node N`` it joins the group torchrun
made. Rank 0 prints.

``--replicas R`` serves R independent replicas behind a
``serve.router.ReplicaRouter`` (request i on replica i % R, no collective
between replicas): with ``--tp 1`` in this process, one CUDA device a
replica (it raises with fewer devices than R) or, with ``--device cpu``,
R replicas on the CPU; with ``--tp T > 1`` over R x T ranks (started as
for ``--tp``, or torchrun's), each rank serving its replica's shard. The
completions are gathered to rank 0, which prints them in submission
order; tokens/s counts every replica's tokens against the slowest
replica's wall time.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import queue
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


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
                        help="tensor-parallel ranks (one a device); params "
                             "must NOT be pre-split (prepare_params_for_tp "
                             "runs here)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="independent replica engines behind a "
                             "round-robin router (serve.router): "
                             "replicas x tp devices, no collective "
                             "between replicas")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.tp == 1:
        return _serve(args, None, print)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return _serve_rank(args)
    return _spawn_ranks(args)


def _serve_rank(args, rank=None, init_method=None, out=None):
    """This process's rank of ``--tp`` (times ``--replicas``): joins the
    group (torchrun's, or the one :func:`_spawn_ranks` starts) and serves
    its replica's shard. Rank 0 prints, or with ``out`` (a queue) sends
    its lines and result there."""
    from sleekit_tpu_torch.parallel.distributed import init_process_group
    from sleekit_tpu_torch.serve.router import local_replica_mesh

    n = args.tp * args.replicas
    if not dist.is_initialized():
        init_process_group(init_method=init_method, rank=rank,
                           world_size=None if rank is None else n,
                           device=args.device)
    if dist.get_world_size() != n:
        raise ValueError(f"--tp {args.tp} --replicas {args.replicas} over "
                         f"a group of {dist.get_world_size()} ranks")
    mesh = local_replica_mesh(args.tp, device=(
        "cpu" if torch.device(args.device).type == "cpu" else None))
    first = dist.get_rank() == 0
    lines = []

    def say(*parts):
        if first and out is None:
            print(*parts)
        elif first:
            lines.append(" ".join(str(p) for p in parts))

    res = _serve(args, mesh, say)
    if out is not None and first:
        del res["engine"]   # stays with its rank
        out.put((lines, res))
    dist.barrier()
    return res


def _rank_main(rank, args, init_method, out):
    torch.set_num_threads(max(1, torch.get_num_threads()
                              // (args.tp * args.replicas)))
    try:
        _serve_rank(args, rank, init_method, out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(args):
    """Start ``--tp`` x ``--replicas`` ranks, one a CUDA device (or CPU
    processes), and print rank 0's lines; returns its result. Raises once
    a rank has exited without rank 0's result."""
    n = args.tp * args.replicas
    if torch.device(args.device).type == "cuda":
        found = torch.cuda.device_count()
        if found < n:
            raise RuntimeError(f"--tp {args.tp} --replicas {args.replicas} "
                               f"needs {n} CUDA devices; found {found}")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        procs = [ctx.Process(target=_rank_main, args=(r, args, init, out))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            while True:
                try:
                    lines, res = out.get(timeout=1.0)
                    break
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode]
                    if dead:
                        raise RuntimeError(f"a rank exited with "
                                           f"{dead[0]}") from None
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = [p.exitcode for p in procs if p.exitcode]
    if failed:
        raise RuntimeError(f"ranks exited with {failed}")
    for line in lines:
        print(line)
    return res


def _serve(args, mesh, say):
    """The command's body on one device, or on this rank of ``mesh``."""
    from sleekit_tpu_torch.device import resolve_device
    from sleekit_tpu_torch.models.zoo import get_config
    from sleekit_tpu_torch.parallel.mesh import prepare_params_for_tp
    from sleekit_tpu_torch.serve.checkpoint import load_packed_params
    from sleekit_tpu_torch.serve.engine import Engine, Request

    dev = resolve_device(args.device) if mesh is None else mesh.device
    cfg = get_config(args.model)
    params, meta = load_packed_params(args.ckpt, cfg=cfg, device=dev)
    say(f"loaded {args.ckpt} (meta: {meta})")
    if mesh is not None:
        params = prepare_params_for_tp(cfg, params, args.tp)
        say(f"tensor-parallel over {args.tp} ranks "
            f"({mesh.group.backend})")

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
    engine_kw = dict(max_slots=args.slots, max_seq_len=args.max_seq_len,
                     seed=args.seed, cache_dtype=cache_dtype,
                     paged=args.paged, page_size=args.page_size,
                     total_pages=args.total_pages)
    ranks = mesh is not None and args.replicas > 1
    if args.replicas > 1:
        from sleekit_tpu_torch.serve.router import (
            ReplicaRouter, replica_meshes)
        if mesh is None:
            meshes = replica_meshes(args.replicas, 1, devices=(
                [dev] * args.replicas if dev.type == "cpu" else None))
            engine = ReplicaRouter(cfg, params, meshes, **engine_kw)
        else:
            engine = ReplicaRouter(cfg, params, [mesh],
                                   replica_ids=[mesh.data_rank],
                                   n_replicas=args.replicas, **engine_kw)
        say(f"data axis: {args.replicas} replica engines, request i on "
            f"replica i % {args.replicas}")
    else:
        engine = Engine(cfg, params, device=dev, mesh=mesh, **engine_kw)

    def mk_reqs():
        return [Request(prompt=p, max_new_tokens=args.max_new_tokens,
                        temperature=args.temperature) for p in prompts]

    def timed_run():
        t0 = time.perf_counter()
        comps = engine.run(mk_reqs())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if ranks:
            comps, dt = _gather_completions(comps, dt, mesh)
        return comps, dt, sum(len(c.new_tokens) for c in comps)

    cold, cold_s, cold_n = timed_run()
    for c in cold:
        say(f"[{c.request_id}] +{len(c.new_tokens)} tokens "
            f"({c.finish_reason}): {c.new_tokens.tolist()}")
    graphs = all(e.graphs for e in (engine.engines.values()
                                    if args.replicas > 1 else [engine]))
    what = ("includes the kernels' first launches and the decode graph's "
            "captures" if graphs else "the first run")
    say(f"{cold_n} tokens in {cold_s:.2f}s = {cold_n / cold_s:.1f} "
        f"tokens/s (cold: {what})")
    # Steady state: the same requests again, every decode graph captured.
    steady, steady_s, steady_n = timed_run()
    say(f"steady state: {steady_n} tokens in {steady_s:.2f}s = "
        f"{steady_n / steady_s:.1f} tokens/s")
    return dict(engine=engine, cold=cold, steady=steady, cold_s=cold_s,
                steady_s=steady_s, cold_tokens_per_s=cold_n / cold_s,
                steady_tokens_per_s=steady_n / steady_s)


def _gather_completions(comps, seconds, mesh):
    """Every replica's completions, in submission order, and the slowest
    replica's wall time, on world rank 0 (one ``gather_object`` over the
    world; each replica's completions from its model rank 0); the other
    ranks keep their own."""
    every = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object((mesh.rank, comps, seconds), every, dst=0)
    if every is None:
        return comps, seconds
    merged = [c for rank, cs, _ in every if rank == 0 for c in cs]
    return (sorted(merged, key=lambda c: c.request_id),
            max(s for _, _, s in every))


if __name__ == "__main__":
    main()
