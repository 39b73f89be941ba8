"""Shared helpers of the port's tests: carry JAX values over to the port
through numpy (bf16 included)."""

import dataclasses

import numpy as np
import pytest
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


def quant_problem(m, n, seed, rank=None, mean=0.3):
    """A quantizer test problem from numpy's seed: W (m, n) standard
    normal and a Hessian H = XᵀX / s from s samples of mean ``mean`` (s =
    ``rank`` if given, else 2n)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((m, n)).astype(np.float32)
    s = rank or 2 * n
    X = (rng.standard_normal((s, n)) + mean).astype(np.float32)
    return W, (X.T @ X / s).astype(np.float32)


def same_codewords(got, want, cb, what=""):
    """Quantized weights on the same codewords (equal codebook indices)
    with values within 1e-6 of the largest: XLA computes a uniform
    codebook's value as a fused multiply-add, one f32 step from
    PyTorch's."""
    got = torch.as_tensor(got)
    want = torch.from_numpy(np.array(want, np.float32))
    np.testing.assert_array_equal(cb.quantize_index(got).numpy(),
                                  cb.quantize_index(want).numpy(),
                                  err_msg=what)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module of many small tensor ops (the
    quantizer's loops): the suite runs several test processes at once,
    and a thread pool per process each op only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
