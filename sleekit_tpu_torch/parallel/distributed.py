"""Process-group start-up and the tensor-parallel collectives (port of
``sleekit_tpu/parallel/distributed.py``).

The JAX package starts one ``jax.distributed`` runtime a host and lets
GSPMD and ``shard_map`` insert its collectives. Here each rank is a
process of one ``torch.distributed`` group: :func:`init_process_group`
starts it (from ``torchrun``'s environment, or from an explicit rank,
world size and init method), :func:`global_mesh` gives the ('data',
'model') mesh over it, and :class:`TPGroup` issues the collectives of one
axis of that mesh (the serving step's, the merge of calibration
statistics, the gather of the mesh solves) over its sub-group of the
world and counts them, the counterpart of ``count_collectives_in_jaxpr``.
NCCL on the card; gloo on the CPU, and for ranks that share one card.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from sleekit_tpu_torch.device import resolve_device

# How long a rank waits on a collective before it raises.
TIMEOUT = datetime.timedelta(seconds=120)


def local_rank() -> int:
    """The rank among this host's processes (``torchrun``'s LOCAL_RANK),
    else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def init_process_group(backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       device="cuda") -> None:
    """Join the process group: with no ``rank``/``world_size``, from the
    environment ``torchrun`` sets (``env://``); else from the given
    ``init_method`` (``file://<path>`` or ``tcp://localhost:<port>``).
    ``backend`` defaults to NCCL for a CUDA ``device`` (which then becomes
    the process's current device, ``cuda:<local rank>``) and gloo for the
    CPU."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if rank is None:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=TIMEOUT)
    if backend == "nccl":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())


def global_mesh(model_parallel: int = 1, device=None):
    """The ('data', 'model') mesh over every rank of the group: model axis
    ``model_parallel``, data axis the ranks over it."""
    from sleekit_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model={model_parallel}")
    return make_mesh(data=n // model_parallel, model=model_parallel,
                     device=device)


# Newer torch calls ``all_gather_into_tensor`` ``all_gather_single`` and
# warns on the old name.
_all_gather_single = getattr(dist, "all_gather_single", None) or (
    dist.all_gather_into_tensor)


class TPGroup:
    """The collectives of one mesh axis over ``ranks`` of the
    ``torch.distributed`` world (all of them by default), each counted in
    :attr:`counts` when it is issued: a call made while a CUDA graph
    captures is counted by the graph's owner at each replay
    (``models/eval.py`` ``DecodeGraph``). ``rank`` and ``size`` are this
    process's place in the group and the group's size.

    A group over part of the world is made with ``dist.new_group``, which
    every rank of the world must call for every group, in the same order,
    members or not: :func:`~sleekit_tpu_torch.parallel.mesh.make_mesh`
    does."""

    def __init__(self, ranks: Optional[Sequence[int]] = None):
        world = dist.get_world_size()
        self.ranks = list(range(world) if ranks is None else ranks)
        # The world's own group where the ranks are all of it.
        self.pg = (None if self.ranks == list(range(world))
                   else dist.new_group(self.ranks))
        me = dist.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1
        self.size = len(self.ranks)
        self.backend = dist.get_backend()
        self.counts: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}

    @property
    def capturable(self) -> bool:
        """Whether its collectives can be captured in a CUDA graph: NCCL's
        can, gloo's cannot."""
        return self.backend == "nccl"

    def _staged(self, t: torch.Tensor) -> bool:
        # gloo reduces on the host: a CUDA tensor goes through a host copy
        # here, explicitly, so that no gloo build's CUDA support is assumed.
        return self.backend == "gloo" and t.is_cuda

    def all_reduce(self, t: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The reduction (by default the sum) over the ranks of ``t``, in
        place; returns ``t``."""
        self.counts["all_reduce"] += 1
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, op=op, group=self.pg)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim``, in rank order."""
        self.counts["all_gather"] += 1
        src = t.cpu() if self._staged(t) else t.contiguous()
        out = torch.empty((self.size * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _all_gather_single(out, src, group=self.pg)
        out = torch.cat(out.chunk(self.size), dim=dim)
        return out.to(t.device)

    def barrier(self) -> None:
        """Wait for every rank of the group (moves no data; not counted)."""
        dist.barrier(group=self.pg)

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0
