"""Data-axis serving: one Engine a replica, shared admission (port of
``sleekit_tpu.serve.router``).

Each data replica is an independent
:class:`~sleekit_tpu_torch.serve.engine.Engine` over its own sub-mesh: one
device, or the model group of its ranks (tensor parallelism inside the
replica). Admission is deterministic, round-robin in submission order, so
processes that each hold only their own replicas make the same decisions
without communicating: no collective crosses the data axis while serving,
and a replica's TP Engine issues only its model group's.

The port runs one process a rank. :func:`replica_meshes` is the
single-process form (one-rank replicas, each pinned to a device; a device
may repeat, so two replicas can share one card or the CPU);
:func:`local_replica_mesh` gives this rank's replica sub-mesh in a world
of R x T ranks, and a router over it holds only that replica.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.parallel.mesh import Mesh, make_mesh, params_to_device
from sleekit_tpu_torch.serve.engine import Completion, Engine, Request


def replica_meshes(n_replicas: int, model_parallel: int = 1,
                   devices=None) -> List[Mesh]:
    """``n_replicas`` one-rank meshes in this process, replica r pinned to
    ``devices[r]``: by default one CUDA device a replica (raising with
    fewer devices than replicas); an explicit list may repeat a device
    (``["cuda:0", "cuda:0"]``, ``["cpu", "cpu"]``). A replica of
    ``model_parallel > 1`` ranks spans processes here: each rank takes its
    sub-mesh from :func:`local_replica_mesh`."""
    if model_parallel > 1:
        raise ValueError(
            f"a replica of model={model_parallel} ranks spans processes "
            "(one a rank): each rank serves its replica through "
            "local_replica_mesh(model_parallel)")
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n_replicas:
            raise RuntimeError(
                f"{n_replicas} replicas need {n_replicas} CUDA devices; "
                f"found {found} (pass devices=, e.g. ['cpu'] * "
                f"{n_replicas})")
        devices = [f"cuda:{r}" for r in range(n_replicas)]
    devices = list(devices)
    if len(devices) < n_replicas:
        raise ValueError(f"{n_replicas} replicas over {len(devices)} "
                         "devices")
    return [Mesh(rank=0, model=1, device=resolve_device(devices[r]),
                 data_rank=r) for r in range(n_replicas)]


def local_replica_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """This rank's replica sub-mesh in a world of R x ``model_parallel``
    ranks: the model group of ``make_mesh(data=R, model=model_parallel)``
    (made on every rank, with its groups), with ``data_rank`` its replica
    id and ``data`` 1. ``device`` as ``make_mesh`` takes it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not split into replicas of "
                         f"model={model_parallel}")
    full = make_mesh(data=world // model_parallel, model=model_parallel,
                     device=device)
    return dataclasses.replace(full, data=1, data_group=None,
                               world=full.group)


class ReplicaRouter:
    """Round-robin request router over per-replica Engines.

    ``meshes``: the sub-meshes of the replicas this process holds (one
    Engine each; a one-rank mesh runs the single-device Engine pinned to
    its device, with its params there). ``replica_ids`` gives their global
    replica indices and ``n_replicas`` the global replica count: every
    process assigns request i to replica ``i % n_replicas`` without
    communicating, and serves only the requests of its replicas.

    ``params`` must already be in the tensor-parallel format where a
    replica has model > 1 ranks (``parallel.mesh.prepare_params_for_tp``),
    as for ``Engine``; ``engine_kw`` goes to every Engine.
    """

    def __init__(self, cfg, params, meshes: Sequence[Mesh],
                 replica_ids: Optional[Sequence[int]] = None,
                 n_replicas: Optional[int] = None, **engine_kw):
        meshes = list(meshes)
        self.replica_ids = list(replica_ids if replica_ids is not None
                                else range(len(meshes)))
        if len(self.replica_ids) != len(meshes):
            raise ValueError(f"{len(self.replica_ids)} replica ids for "
                             f"{len(meshes)} meshes")
        self.n_replicas = n_replicas or len(meshes)
        if not all(0 <= r < self.n_replicas for r in self.replica_ids):
            raise ValueError(f"replica ids {self.replica_ids} outside "
                             f"0..{self.n_replicas - 1}")
        self.engines: Dict[int, Engine] = {}
        for rid, mesh in zip(self.replica_ids, meshes):
            if mesh.model == 1:
                self.engines[rid] = Engine(
                    cfg, params_to_device(params, mesh.device),
                    device=mesh.device, **engine_kw)
            else:
                self.engines[rid] = Engine(cfg, params, mesh=mesh,
                                           **engine_kw)
        self._next_idx = 0
        self._assignment: Dict[int, int] = {}    # request_id -> replica

    def submit(self, req: Request) -> int:
        """Assign the request to replica ``i % n_replicas`` (i: the global
        submission index) and queue it there if that replica is local.
        A request without an id takes the submission index, so every
        process labels it alike. Returns its id."""
        rep = self._next_idx % self.n_replicas
        self._next_idx += 1
        if req.request_id < 0:
            req.request_id = self._next_idx - 1
        self._assignment[req.request_id] = rep
        if rep in self.engines:
            self.engines[rep].submit(req)
        return req.request_id

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines.values())

    def step(self) -> None:
        """One scheduling iteration of each local replica in turn."""
        for e in self.engines.values():
            if e.has_work():
                e.step_auto()

    def run(self, requests: Sequence[Request]) -> List[Completion]:
        """Submit every request, serve the local ones to completion and
        return their completions in submission order (the others are
        served by the processes that hold their replicas)."""
        ids = [self.submit(r) for r in requests]
        while self.has_work():
            self.step()
        by_id: Dict[int, Completion] = {}
        for e in self.engines.values():
            for c in e.finished:
                by_id[c.request_id] = c
            e.finished = []
        return [by_id[i] for i in ids if i in by_id]

    def owner(self, request_id: int) -> int:
        """The global replica that serves the request."""
        return self._assignment[request_id]
