"""Ranks of a gloo process group for the port's tensor-parallel tests.

:class:`Ranks` starts ``n`` spawned processes that join one gloo group
(rendezvous through a file, so concurrent test processes never share a
port) and serve jobs: each job is a function of this module that every
rank runs on its own shard, returning numpy values. One group serves a
whole test module, since a process takes seconds to start. This module
imports torch and the port only: a spawned rank imports it, and never
JAX or the tests' conftest.
"""

from __future__ import annotations

import multiprocessing
import queue
import traceback

import numpy as np
import torch

# Seconds a job may take on a rank before the test fails.
JOB_TIMEOUT = 300


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree


def _tensors(tree):
    from sleekit_tpu_torch.convert import _tensor

    return {k: _tensor(v, "cpu") for k, v in tree.items()}


def _mesh_params(cfg, tree, mesh):
    """The rank's block of a numpy param tree (unsplit, unfused)."""
    from sleekit_tpu_torch.convert import params_from_numpy
    from sleekit_tpu_torch.parallel.mesh import (
        prepare_params_for_tp, shard_params)

    params = params_from_numpy(cfg, tree, device="cpu")
    return shard_params(cfg, prepare_params_for_tp(cfg, params, mesh.model),
                        mesh)


# ---- jobs (run on every rank: (mesh, **kw) -> numpy) ----------------------


def prefill_decode(mesh, cfg, params, tokens, cache_dtype, decode_cache,
                   nxt, pos):
    """``tp_prefill`` of ``tokens`` into a fresh cache of the local config
    (S = 32; f32 scale planes for an int8 one), then one ``tp_decode_step`` of ``nxt`` at ``pos`` over the
    rank's shard of ``decode_cache`` (a full slot cache or page pool).
    Returns both logits, both local caches and the collectives each
    issued."""
    from sleekit_tpu_torch.models.transformer import init_kv_cache
    from sleekit_tpu_torch.parallel.mesh import shard_kv_cache
    from sleekit_tpu_torch.parallel.tp_decode import (
        _local_cfg, tp_decode_step, tp_prefill)

    local = _mesh_params(cfg, params, mesh)
    group = mesh.group
    cache = init_kv_cache(_local_cfg(cfg, mesh.model), tokens.shape[0], 32,
                          cache_dtype, torch.float32, device="cpu")
    group.reset_counts()
    logits, cache = tp_prefill(cfg, local, torch.from_numpy(tokens), cache,
                               mesh)
    out = {"prefill_logits": logits, "prefill_cache": cache,
           "prefill_counts": dict(group.counts)}
    dcache = shard_kv_cache(_tensors(decode_cache), mesh)
    group.reset_counts()
    logits, dcache = tp_decode_step(cfg, local, torch.from_numpy(nxt),
                                    dcache, torch.from_numpy(pos), mesh)
    out.update(decode_logits=logits, decode_cache=dcache,
               decode_counts=dict(group.counts))
    return _numpy(out)


def engine_tokens(mesh, cfg, params, specs, engine_kw, split=False):
    """``Engine(mesh=...)`` over the rank's shard: the new tokens of each
    request of ``specs`` (each a dict of ``Request``'s fields). With
    ``split``, ``params`` is already in the tensor-parallel format (a
    checkpoint path of split params)."""
    from sleekit_tpu_torch.convert import params_from_numpy
    from sleekit_tpu_torch.parallel.mesh import prepare_params_for_tp
    from sleekit_tpu_torch.serve.checkpoint import load_packed_params
    from sleekit_tpu_torch.serve.engine import Engine, Request

    if split:
        full, _ = load_packed_params(params, cfg=cfg, device="cpu")
    else:
        full = prepare_params_for_tp(
            cfg, params_from_numpy(cfg, params, device="cpu"), mesh.model)
    engine = Engine(cfg, full, mesh=mesh, **engine_kw)
    comps = engine.run([Request(**spec) for spec in specs])
    return [c.new_tokens for c in comps]


# ---- the ranks ------------------------------------------------------------


def _serve(rank, size, init_file, jobs, results):
    from sleekit_tpu_torch.parallel.distributed import init_process_group
    from sleekit_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    init_process_group(init_method=f"file://{init_file}", rank=rank,
                       world_size=size, device="cpu")
    mesh = make_mesh(model=size, device="cpu")
    while True:
        job = jobs.get()
        if job is None:
            break
        name, kw = job
        try:
            results.put((rank, True, globals()[name](mesh, **kw)))
        except Exception:  # reported to the test, which fails on it
            results.put((rank, False, traceback.format_exc()))
    torch.distributed.destroy_process_group()


class Ranks:
    """``n`` spawned ranks of one gloo group, serving jobs of this module
    until :meth:`close`."""

    def __init__(self, n: int, root):
        ctx = multiprocessing.get_context("spawn")
        self.jobs = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(
            target=_serve, args=(r, n, str(root / "rendezvous"),
                                 self.jobs[r], self.results), daemon=True)
            for r in range(n)]
        for p in self.procs:
            p.start()

    def __call__(self, job: str, **kw):
        """Every rank's result of ``job(mesh, **kw)``, in rank order."""
        for q in self.jobs:
            q.put((job, kw))
        got = {}
        try:
            for _ in self.procs:
                rank, ok, value = self.results.get(timeout=JOB_TIMEOUT)
                if not ok:
                    raise AssertionError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        except queue.Empty:
            raise AssertionError(f"{job}: no result from ranks "
                                 f"{sorted(set(range(len(self.procs))) - set(got))} "
                                 f"in {JOB_TIMEOUT} s") from None
        return [got[r] for r in range(len(self.procs))]

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def same_on_every_rank(results, key):
    """``results[r][key]`` of rank 0, after checking every rank equal."""
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first
