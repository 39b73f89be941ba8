"""The ('data', 'model') mesh and the tensor-parallel sharding rules (port
of ``sleekit_tpu/parallel/mesh.py``).

The JAX package lays one ``Mesh`` over its devices, annotates each leaf of
the param and cache trees with a ``PartitionSpec`` and lets ``shard_map``
hand every device its block. Here a process is one rank of a
``torch.distributed`` world of ``data * model`` ranks, laid out row-major
as ``mesh_utils.create_device_mesh((data, model))`` lays out devices
(rank = d * model + m): :class:`Mesh` is that rank's view (its place on
both axes, a group for each axis and one over the world, its device).
The data axis holds replicas (``serve.router``), the rows of a
calibration batch (``models/quantize.py`` ``calibrate``) and, with the
model axis, the layers of a mesh solve (statistics replicated: every rank
holds them all, the counterpart of ``stats_specs``).
:func:`shard_params` / :func:`shard_kv_cache` cut the rank's block of the
model axis out of a full tree, by the same rules:

* column-parallel linears (q, k, v, fc1, gate, up): output columns;
* row-parallel linears (o, fc2, down): input rows, the packed ones as
  :func:`~sleekit_tpu_torch.ops.pack.split_packed_k` word rows; their
  scale and bias are replicated;
* the lm_head over the vocab (the int8 head over its padded width);
* embeddings and norms replicated;
* the KV cache and the page pool over the kv-head axis; the page table
  replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.ops.pack import (
    PackedLinear, localize_packed_shard, split_packed_k)
from sleekit_tpu_torch.parallel.distributed import TPGroup, local_rank

# Column-parallel linears: output dim sharded over 'model' (their outputs
# are head-/ff-sharded activations). Row-parallel linears: input dim
# sharded; their partial outputs are all-reduced.
_COL_PARALLEL = ("q", "k", "v", "fc1", "gate", "up", "qkv", "gate_up")
_ROW_PARALLEL = ("o", "fc2", "down")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ('data', 'model') mesh: ``model`` ranks of
    ``group`` (a
    :class:`~sleekit_tpu_torch.parallel.distributed.TPGroup` over the
    model axis, or None for a mesh of one rank without a process group),
    this process's ``rank`` among them, and the device its shard lives on;
    ``data`` replicas, this rank's replica ``data_rank``, ``data_group``
    (the ranks of its model index on every replica; None at ``data ==
    1``) and ``world`` (a group over all ``data * model`` ranks; None
    without a process group). A replica's sub-mesh
    (``serve.router.local_replica_mesh``) has ``data`` 1, keeps
    ``data_rank`` as its replica id, and its ``world`` is its ``group``."""

    rank: int
    model: int
    device: torch.device
    group: Any = None
    data: int = 1
    data_rank: int = 0
    data_group: Any = None
    world: Any = None


def make_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """This process's rank of a ('data', 'model') mesh over the initialized
    ``torch.distributed`` world (``distributed.init_process_group``) of
    ``data * model`` ranks, row-major (rank = d * model + m), or of a
    one-rank mesh when there is none and ``data == model == 1``. Every
    rank of the world makes every group, in the same order. ``device``:
    the rank's device; by default the CUDA device of its local rank
    (``LOCAL_RANK`` modulo the devices present), raising where there is
    none; pass ``"cpu"`` for the CPU (gloo)."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != size:
        raise ValueError(f"data={data} x model={model} needs a group of "
                         f"{data * model} ranks (found {size}); start the "
                         "ranks with distributed.init_process_group")
    dev = resolve_device("cuda" if device is None else device)
    if device is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    if not dist.is_initialized():
        return Mesh(rank=0, model=1, device=dev)
    me = dist.get_rank()
    d, m = divmod(me, model)
    model_groups = [TPGroup(range(r * model, (r + 1) * model))
                    for r in range(data)]
    data_groups = ([TPGroup(range(c, size, model)) for c in range(model)]
                   if data > 1 else None)
    group = model_groups[d]
    world = group if data == 1 else TPGroup()
    return Mesh(rank=m, model=model, device=dev, group=group, data=data,
                data_rank=d,
                data_group=None if data_groups is None else data_groups[m],
                world=world)


def params_to_device(tree, device):
    """A param tree (dicts, lists, PackedLinears, tensors) with every
    tensor on ``device``; a tensor already there is shared, not copied."""
    if isinstance(tree, PackedLinear):
        return dataclasses.replace(
            tree, **{k: params_to_device(getattr(tree, k), device)
                     for k in ("packed", "scale", "lut", "bias")})
    if isinstance(tree, dict):
        return {k: params_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_to_device(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def prepare_params_for_tp(cfg, params, n: int):
    """Packed params in the tensor-parallel format: row-parallel packed
    linears (o, fc2, down) re-packed with ``split_packed_k(p, n)``, so
    their word rows cut into ``n`` self-contained packings. Dense linears
    and column-parallel packed ones keep their format. Fused q|k|v and
    gate|up are refused: fusion concatenates across the shard boundary."""
    if n == 1:
        return params
    out = dict(params)
    layers = []
    for layer in params["layers"]:
        if "qkv" in layer["attn"] or "gate_up" in layer["mlp"]:
            raise ValueError("tensor parallelism needs unfused q/k/v and "
                             "gate/up (fuse_qkv_params is single-device "
                             "serving only)")
        layer = {**layer, "attn": dict(layer["attn"]),
                 "mlp": dict(layer["mlp"])}
        for grp in ("attn", "mlp"):
            for name, p in layer[grp].items():
                if name in _ROW_PARALLEL and isinstance(p, PackedLinear):
                    layer[grp][name] = split_packed_k(p, n)
        layers.append(layer)
    out["layers"] = layers
    return out


def _cut(t: Optional[torch.Tensor], dim: int, mesh: Mesh, device):
    """The rank's block of ``t`` along ``dim`` (all of it for dim None), on
    ``device``, contiguous."""
    if t is None:
        return None
    if dim is not None:
        if t.shape[dim] % mesh.model:
            raise ValueError(f"axis {dim} of {tuple(t.shape)} does not "
                             f"split into {mesh.model} shards")
        size = t.shape[dim] // mesh.model
        t = t.narrow(dim, mesh.rank * size, size)
    return t.to(device).contiguous()


def _shard_linear(name: str, p, mesh: Mesh, device):
    col = name in _COL_PARALLEL
    if isinstance(p, PackedLinear):
        local = dataclasses.replace(
            p, packed=_cut(p.packed, 1 if col else 0, mesh, device),
            scale=_cut(p.scale, 0 if col else None, mesh, device),
            lut=_cut(p.lut, None, mesh, device),
            bias=_cut(p.bias, 0 if col else None, mesh, device))
        return localize_packed_shard(local, mesh.model, row_parallel=not col)
    out = {"kernel": _cut(p["kernel"], 1 if col else 0, mesh, device)}
    if "bias" in p:
        out["bias"] = _cut(p["bias"], 0 if col else None, mesh, device)
    return out


def shard_params(cfg, params, mesh: Mesh):
    """This rank's block of a full (``prepare_params_for_tp``) param tree,
    on the mesh's device, with each PackedLinear's static fields made local
    (the counterpart of ``shard_pytree`` over ``param_specs`` and of
    ``tp_decode._localize_packed``, which are one step here)."""
    dev = mesh.device
    out = {"embed": params_to_device(params["embed"], dev)}
    out["layers"] = [{
        "ln1": params_to_device(layer["ln1"], dev),
        "ln2": params_to_device(layer["ln2"], dev),
        "attn": {k: _shard_linear(k, v, mesh, dev)
                 for k, v in layer["attn"].items()},
        "mlp": {k: _shard_linear(k, v, mesh, dev)
                for k, v in layer["mlp"].items()},
    } for layer in params["layers"]]
    if "final_ln" in params:
        out["final_ln"] = params_to_device(params["final_ln"], dev)
    if "lm_head" in params:
        # Column-parallel over the vocab; the step all-gathers the logits.
        out["lm_head"] = _shard_linear("q", params["lm_head"], mesh, dev)
    return out


def shard_kv_cache(cache, mesh: Mesh):
    """This rank's block of a stacked slot cache ((L, B, KV, S, D), scale
    planes (L, B, KV, S)) or page pool ((L, P, KV, PS, D), scale planes
    (L, P, KV, PS)): the kv-head axis (2) sharded; the page table
    replicated."""
    return {k: (_cut(v, None, mesh, mesh.device) if k == "page_table"
                else _cut(v, 2, mesh, mesh.device))
            for k, v in cache.items()}
