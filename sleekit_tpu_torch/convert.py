"""Carry parameters produced by the JAX package over to the port.

The input is a tree of numpy arrays: nested dicts and lists, with each
``PackedLinear`` given as a dict of its fields (``packed``, ``scale``,
``lut``, ``bias``, ``in_features``, ``out_features``, ``nbits``,
``affine``, ``layout``, optionally ``k_splits``). Both layer layouts are
accepted: the per-layer list, and the stacked ``scan_layers`` dict whose
leaves carry a leading layer axis. The port keeps a per-layer list; the
packed words of a stacked tree stay one contiguous (L, kw, N) tensor, and
each layer's ``PackedLinear`` holds the zero-copy view ``packed[l]``.

bf16 arrays (numpy dtype name ``bfloat16``, or the 2-byte void ``|V2``
that an ``.npz`` file makes of them) are carried bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.ops.pack import PackedLinear

_PACKED_FIELDS = {"packed", "scale", "lut", "in_features", "out_features",
                  "nbits", "layout"}


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _is_packed(node) -> bool:
    return isinstance(node, dict) and _PACKED_FIELDS <= set(node)


def _packed_linear(node, device, layer=None) -> PackedLinear:
    def arr(key):
        v = node.get(key)
        if v is None:
            return None
        t = v if isinstance(v, torch.Tensor) else _tensor(v, device)
        return t if layer is None else t[layer]

    affine = node.get("affine")
    return PackedLinear(
        packed=arr("packed"), scale=arr("scale"), lut=arr("lut"),
        bias=arr("bias"), in_features=int(node["in_features"]),
        out_features=int(node["out_features"]), nbits=int(node["nbits"]),
        affine=None if affine is None else tuple(float(a) for a in affine),
        layout=str(node["layout"]), k_splits=int(node.get("k_splits", 1)))


def _convert(node, device) -> Any:
    if _is_packed(node):
        return _packed_linear(node, device)
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    return _tensor(node, device)


def _device_tree(node, device):
    """Stacked subtree with array leaves moved to the device once (so the
    per-layer views below share storage)."""
    if _is_packed(node):
        return {k: (_tensor(v, device) if k in ("packed", "scale", "lut",
                                                "bias") and v is not None
                    else v) for k, v in node.items()}
    if isinstance(node, dict):
        return {k: _device_tree(v, device) for k, v in node.items()}
    return _tensor(node, device)


def _layer_view(node, layer: int):
    if _is_packed(node):
        return _packed_linear(node, None, layer)
    if isinstance(node, dict):
        return {k: _layer_view(v, layer) for k, v in node.items()}
    return node[layer]


def _leading_axis(node) -> int:
    """The layer count of a stacked subtree: its first leaf's leading
    axis."""
    if _is_packed(node):
        return int(np.shape(node["packed"])[0])
    if isinstance(node, dict):
        return _leading_axis(next(iter(node.values())))
    return int(np.shape(node)[0])


def params_from_numpy(cfg, tree, device="cuda"):
    """The port's params for ``cfg`` from a numpy tree of the JAX package's
    params (per-layer list or stacked layers; a stacked tree's L comes
    from the leaves when ``cfg`` is None). A tree without ``layers`` is
    converted leaf by leaf."""
    dev = resolve_device(device)
    out = {k: _convert(v, dev) for k, v in tree.items() if k != "layers"}
    layers = tree.get("layers")
    if isinstance(layers, dict):
        n = cfg.n_layers if cfg is not None else _leading_axis(layers)
        stacked = _device_tree(layers, dev)
        out["layers"] = [_layer_view(stacked, i) for i in range(n)]
    elif layers is not None:
        out["layers"] = [_convert(layer, dev) for layer in layers]
    return out
