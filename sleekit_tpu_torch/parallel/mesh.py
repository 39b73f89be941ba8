"""The ('data', 'model') mesh and the tensor-parallel sharding rules (port
of ``sleekit_tpu/parallel/mesh.py``).

The JAX package lays one ``Mesh`` over its devices, annotates each leaf of
the param and cache trees with a ``PartitionSpec`` and lets ``shard_map``
hand every device its block. Here a process is one rank of a
``torch.distributed`` group: :class:`Mesh` is that rank's view (its rank,
the group, its device), and :func:`shard_params` / :func:`shard_kv_cache`
cut the rank's block out of a full tree, by the same rules:

* column-parallel linears (q, k, v, fc1, gate, up): output columns;
* row-parallel linears (o, fc2, down): input rows, the packed ones as
  :func:`~sleekit_tpu_torch.ops.pack.split_packed_k` word rows; their
  scale and bias are replicated;
* the lm_head over the vocab (the int8 head over its padded width);
* embeddings and norms replicated;
* the KV cache and the page pool over the kv-head axis; the page table
  replicated.

Only the model axis is ported: the data axis (replicas behind a router)
comes with ``serve/router.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

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
    """One rank's view of a ('data', 'model') mesh of one replica:
    ``model`` ranks of ``group`` (a
    :class:`~sleekit_tpu_torch.parallel.distributed.TPGroup`, or None for
    a mesh of one rank without a process group), this process's ``rank``
    among them, and the device its shard lives on."""

    rank: int
    model: int
    device: torch.device
    group: Any = None


def make_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """This process's rank of a ('data', 'model') mesh over the initialized
    ``torch.distributed`` group (``distributed.init_process_group``), or
    of a one-rank mesh when there is none and ``model == 1``. ``device``:
    the rank's device; by default the CUDA device of its local rank
    (``LOCAL_RANK`` modulo the devices present), raising where there is
    none; pass ``"cpu"`` for the CPU (gloo)."""
    if data != 1:
        raise NotImplementedError(
            "the data axis (replicas, each an Engine on its own devices) is "
            "not ported yet (ROADMAP, modules to port: parallel/ and "
            "serve/router.py, its second PR: the router)")
    group = TPGroup() if torch.distributed.is_initialized() else None
    size = group.size if group is not None else 1
    if model != size:
        raise ValueError(f"model={model} needs a group of {model} ranks "
                         f"(found {size}); start the ranks with "
                         "distributed.init_process_group")
    rank = group.rank if group is not None else 0
    dev = resolve_device("cuda" if device is None else device)
    if device is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return Mesh(rank=rank, model=model, device=dev, group=group)


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


def _replicate(tree, device):
    if isinstance(tree, dict):
        return {k: _replicate(v, device) for k, v in tree.items()}
    return tree.to(device)


def shard_params(cfg, params, mesh: Mesh):
    """This rank's block of a full (``prepare_params_for_tp``) param tree,
    on the mesh's device, with each PackedLinear's static fields made local
    (the counterpart of ``shard_pytree`` over ``param_specs`` and of
    ``tp_decode._localize_packed``, which are one step here)."""
    dev = mesh.device
    out = {"embed": _replicate(params["embed"], dev)}
    out["layers"] = [{
        "ln1": _replicate(layer["ln1"], dev),
        "ln2": _replicate(layer["ln2"], dev),
        "attn": {k: _shard_linear(k, v, mesh, dev)
                 for k, v in layer["attn"].items()},
        "mlp": {k: _shard_linear(k, v, mesh, dev)
                for k, v in layer["mlp"].items()},
    } for layer in params["layers"]]
    if "final_ln" in params:
        out["final_ln"] = _replicate(params["final_ln"], dev)
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
