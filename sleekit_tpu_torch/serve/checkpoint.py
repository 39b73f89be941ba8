"""Quantized-model checkpoints (port of ``sleekit_tpu/serve/checkpoint.py``).

The skq1/skq2 store is shared with the JAX package: one ``manifest.json``
describing the tree structure and the static ``PackedLinear`` metadata,
and one ``tensors.npz`` with every array leaf under a flat ``t<i>`` key.
A checkpoint written by either package loads in the other, with the
packed words, scales, LUTs and dense leaves unchanged.

bf16 leaves: numpy stores the JAX package's bf16 arrays (``ml_dtypes``)
as 2-byte void (``|V2``), and the port writes its bf16 tensors in the
same form; loading reads ``|V2`` as bf16 bits. (The JAX package's own
loader cannot turn ``|V2`` back into an array; see ROADMAP.md, faults.)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from sleekit_tpu_torch.convert import params_from_numpy
from sleekit_tpu_torch.ops.pack import PackedLinear

# skq2 = skq1 + the persisted ``k_splits`` (the tensor-parallel row-shard
# format); skq1 checkpoints are all k_splits = 1.
FORMAT_VERSION = "skq2"
_READABLE_FORMATS = ("skq1", "skq2")


def _to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _store(arrays: List[np.ndarray], x) -> str:
    arrays.append(_to_numpy(x))
    return f"t{len(arrays) - 1}"


def _flatten(tree, arrays: List[np.ndarray]):
    if isinstance(tree, PackedLinear):
        return {
            "__packed__": True,
            "in_features": tree.in_features,
            "out_features": tree.out_features,
            "nbits": tree.nbits,
            "affine": list(tree.affine) if tree.affine else None,
            "layout": tree.layout,
            "k_splits": tree.k_splits,
            "packed": _store(arrays, tree.packed),
            "scale": _store(arrays, tree.scale),
            "lut": _store(arrays, tree.lut),
            "bias": None if tree.bias is None else _store(arrays, tree.bias),
        }
    if isinstance(tree, dict):
        return {k: _flatten(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, arrays) for v in tree]
    if tree is None:
        return None
    return _store(arrays, tree)


def save_packed_params(path: str, params, meta: Dict[str, Any] = None
                       ) -> None:
    """Write a packed (or mixed dense/packed) param tree to ``path``."""
    os.makedirs(path, exist_ok=True)
    arrays: List[np.ndarray] = []
    manifest = {"format": FORMAT_VERSION, "tree": _flatten(params, arrays),
                "meta": meta or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    np.savez(os.path.join(path, "tensors.npz"),
             **{f"t{i}": a for i, a in enumerate(arrays)})


def _rebuild(desc, tensors):
    """The numpy tree ``params_from_numpy`` takes: each packed entry a
    dict of ``PackedLinear`` fields."""
    if isinstance(desc, dict):
        if desc.get("__packed__"):
            node = {k: v for k, v in desc.items() if k != "__packed__"}
            for key in ("packed", "scale", "lut", "bias"):
                if node.get(key) is not None:
                    node[key] = tensors[node[key]]
            node.setdefault("layout", "linear")
            node.setdefault("k_splits", 1)
            return node
        return {k: _rebuild(v, tensors) for k, v in desc.items()}
    if isinstance(desc, list):
        return [_rebuild(v, tensors) for v in desc]
    if desc is None:
        return None
    return tensors[desc]


def load_packed_params(path: str, cfg=None, device="cuda"
                       ) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint written by :func:`save_packed_params` or by the
    JAX package. Returns (params, meta). A stacked (``scan_layers``) tree
    loads into the port's per-layer list (its L from ``cfg``, or from the
    leaves' leading axis). Runs on the CUDA device unless ``device`` says
    otherwise."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") not in _READABLE_FORMATS:
        raise ValueError(
            f"unsupported checkpoint format {manifest.get('format')}")
    with np.load(os.path.join(path, "tensors.npz")) as npz:
        tensors = {k: npz[k] for k in npz.files}
    tree = _rebuild(manifest["tree"], tensors)
    return (params_from_numpy(cfg, tree, device=device),
            manifest.get("meta", {}))

