"""Shared helpers of the port's tests: carry JAX values over to the port
through numpy (bf16 included)."""

import dataclasses

import numpy as np
import torch


def to_numpy_tree(tree):
    """A JAX params tree as the numpy tree ``params_from_numpy`` takes:
    arrays become numpy arrays, each PackedLinear a dict of its fields."""
    from sleekit_tpu.ops.pack import PackedLinear

    if isinstance(tree, PackedLinear):
        out = {f.name: getattr(tree, f.name)
               for f in dataclasses.fields(tree) if f.name != "layer_sel"}
        for key in ("packed", "scale", "lut", "bias"):
            if out[key] is not None:
                out[key] = np.asarray(out[key])
        return out
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def t(a, dtype=None) -> torch.Tensor:
    """numpy or JAX array -> CPU tensor (bf16 kept bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        out = torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def f32(x) -> np.ndarray:
    """Tensor or JAX array -> f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def bf16_close(got, ref, what=""):
    """The kernels' bf16 tolerance: rtol 2^-6 and atol 1e-2*max|ref|.
    Both sides round pre(x) and the output to bf16 (2^-8 relative each)
    and sum in another order."""
    got, ref = f32(got), f32(ref)
    np.testing.assert_allclose(got, ref, rtol=2 ** -6,
                               atol=1e-2 * np.abs(ref).max(), err_msg=what)
