"""Ranks of a gloo process group for the port's tensor-parallel and
data-parallel tests.

:class:`Ranks` starts ``n`` spawned processes that join one gloo group
(rendezvous through a file, so concurrent test processes never share a
port), lay a ('data', 'model') mesh over it (``data`` replicas of ``n //
data`` ranks) and serve jobs: each job is a function of this module that
every rank runs on its own shard, returning numpy values. One group
serves a whole test module, since a process takes seconds to start. This
module imports torch and the port only: a spawned rank imports it, and
never JAX or the tests' conftest.
"""

from __future__ import annotations

import multiprocessing
import os
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


def _collectives(record):
    """Patches ``torch.distributed``'s all-reduce and the port's all-gather
    to append each call's (name, group's ranks) to ``record``; returns
    the undo function."""
    import torch.distributed as dist
    from sleekit_tpu_torch.parallel import distributed as pd

    real = {"all_reduce": dist.all_reduce, "all_gather": pd._all_gather_single}

    def recording(name):
        def call(*a, group=None, **kw):
            ranks = (list(range(dist.get_world_size())) if group is None
                     else dist.get_process_group_ranks(group))
            record.append((name, ranks))
            return real[name](*a, group=group, **kw)
        return call

    dist.all_reduce = recording("all_reduce")
    pd._all_gather_single = recording("all_gather")

    def undo():
        dist.all_reduce = real["all_reduce"]
        pd._all_gather_single = real["all_gather"]
    return undo


def router_tokens(mesh, cfg, params, specs, engine_kw, engine_on_mesh=False):
    """This rank's replica, from ``local_replica_mesh``, behind a
    ``ReplicaRouter`` that holds only it (``n_replicas``: the mesh's
    data axis), serving every request of ``specs``: its completions'
    ids and new tokens, the owner of each request, its replica id, every
    collective issued while serving (name, group's ranks) and the replica
    model group's counts. With ``engine_on_mesh``, the message of
    ``Engine(mesh=mesh)`` over the whole (data > 1) mesh, which must
    raise."""
    from sleekit_tpu_torch.convert import params_from_numpy
    from sleekit_tpu_torch.parallel.mesh import prepare_params_for_tp
    from sleekit_tpu_torch.serve.engine import Engine, Request
    from sleekit_tpu_torch.serve.router import (
        ReplicaRouter, local_replica_mesh)

    full = prepare_params_for_tp(
        cfg, params_from_numpy(cfg, params, device="cpu"), mesh.model)
    if engine_on_mesh:
        try:
            Engine(cfg, full, mesh=mesh, **engine_kw)
        except ValueError as e:
            return str(e)
        raise AssertionError("Engine(mesh=) with data > 1 served")
    sub = local_replica_mesh(mesh.model, device="cpu")
    router = ReplicaRouter(cfg, full, [sub], replica_ids=[sub.data_rank],
                           n_replicas=mesh.data, **engine_kw)
    record = []
    undo = _collectives(record)
    try:
        comps = router.run([Request(**spec) for spec in specs])
    finally:
        undo()
    return _numpy(dict(
        ids=[c.request_id for c in comps],
        tokens=[c.new_tokens for c in comps],
        owners=[router.owner(i) for i in range(len(specs))],
        replica=sub.data_rank, model_ranks=sub.group.ranks,
        data_ranks=mesh.data_group.ranks, collectives=record,
        counts=dict(sub.group.counts)))


def calibrate_job(mesh, cfg, params, batches):
    """``calibrate(mesh=mesh)`` on every rank's rows of ``batches``: the
    merged statistics and the data group's collectives."""
    from sleekit_tpu_torch.convert import params_from_numpy
    from sleekit_tpu_torch.models.quantize import calibrate

    tparams = params_from_numpy(cfg, params, device="cpu")
    mesh.data_group.reset_counts()
    stats = calibrate(cfg, tparams, batches, mesh=mesh)
    return _numpy(dict(stats={k: dict(mean=v.mean, hessian=v.hessian,
                                      count=v.count)
                              for k, v in stats.items()},
                       counts=dict(mesh.data_group.counts)))


def finalize_job(mesh, shards, n):
    """This rank's partial statistics over its shards of ``shards``
    (``shards[data_rank::data]``, ``update_stats`` shard by shard),
    merged by ``finalize_psum`` over the data group."""
    from sleekit_tpu_torch.hessian import (
        finalize_psum, init_stats, update_stats)

    st = init_stats(n, device="cpu")
    mesh.data_group.reset_counts()
    for x in shards[mesh.data_rank::mesh.data]:
        st = update_stats(st, torch.from_numpy(x))
    got = finalize_psum(st, mesh.data_group)
    return _numpy(dict(mean=got.mean, hessian=got.hessian, count=got.count,
                       counts=dict(mesh.data_group.counts)))


def quantize_job(mesh, cfg, params, stats, qconfig, resume_dir=None,
                 budgets=None, workspace=None, pack=False):
    """``quantize_model(layer_parallel=True, mesh=mesh)`` on the whole
    model and statistics (numpy), on every rank: each linear's kernel
    (packed words with ``pack``), the reports' errors, the chunks each
    shape group was cut into, and the world's collectives. ``budgets``
    (bytes, one a rank) and ``workspace`` (bytes a lane) force the chunk
    plan as ``QUANT_HBM_LIMIT`` and a patched ``solve_workspace`` would,
    with another budget on each rank."""
    from sleekit_tpu_torch.convert import params_from_numpy
    from sleekit_tpu_torch.hessian import stats_from_numpy
    from sleekit_tpu_torch.models import quantize as tq
    from sleekit_tpu_torch.models.transformer import (
        get_linear_param, layer_names)
    from sleekit_tpu_torch.pipeline import QuantConfig

    tparams = params_from_numpy(cfg, params, device="cpu")
    tstats = {k: stats_from_numpy(v["mean"], v["hessian"], v["count"],
                                  device="cpu") for k, v in stats.items()}
    chunks = []
    real_batch, real = tq._solve_layer_batch, (tq.hbm_limit,
                                                tq.solve_workspace)

    def batch(params, stats, group, *a):
        chunks.append(len(group))
        return real_batch(params, stats, group, *a)

    tq._solve_layer_batch = batch
    if budgets is not None:
        os.environ["QUANT_HBM_LIMIT"] = str(budgets[mesh.world.rank])
        tq.hbm_limit = lambda dev: float(budgets[mesh.world.rank])
        tq.solve_workspace = lambda k: float(workspace)
    mesh.world.reset_counts()
    try:
        out, reports = tq.quantize_model(
            cfg, tparams, tstats, QuantConfig(**qconfig), pack=pack,
            layer_parallel=True, mesh=mesh, resume_dir=resume_dir)
    finally:
        tq._solve_layer_batch = real_batch
        tq.hbm_limit, tq.solve_workspace = real
        os.environ.pop("QUANT_HBM_LIMIT", None)
    return _numpy(dict(
        kernels={n: (get_linear_param(out, n).packed if pack
                     else get_linear_param(out, n)["kernel"])
                 for n in layer_names(cfg)},
        errors={r.name: r.error for r in reports},
        walls={r.name: r.wall_s for r in reports},
        chunks=chunks, counts=dict(mesh.world.counts)))


# ---- the ranks ------------------------------------------------------------


def _serve(rank, size, data, init_file, jobs, results):
    from sleekit_tpu_torch.parallel.distributed import init_process_group
    from sleekit_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    init_process_group(init_method=f"file://{init_file}", rank=rank,
                       world_size=size, device="cpu")
    mesh = make_mesh(data=data, model=size // data, device="cpu")
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
    """``n`` spawned ranks of one gloo group, a mesh of ``data`` replicas
    of ``n // data`` ranks over it, serving jobs of this module until
    :meth:`close`."""

    def __init__(self, n: int, root, data: int = 1):
        ctx = multiprocessing.get_context("spawn")
        self.jobs = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(
            target=_serve, args=(r, n, data, str(root / "rendezvous"),
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
