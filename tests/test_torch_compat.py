"""The port's torch-facing ``Sleekit`` (``sleekit_tpu_torch/compat.py``)
against the JAX package's (mirrors tests/test_compat.py): count semantics
for Linear, Conv1d and Conv2d (padding included), the Hessian against a
manual one, quantization in place on JAX's codewords (statistics fed by a
forward hook that the caller registers), the HF ``Conv1D`` extension and
the ``.pt`` export round trip."""

import copy
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

from sleekit_tpu import Sleekit as JSleekit
from sleekit_tpu_torch import Sleekit

from tests._torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_linear_counts():
    stats = Sleekit(nn.Linear(10, 5))
    stats.add_batch(torch.randn(10))
    assert stats.count == 1
    stats.add_batch(torch.randn(3, 10))
    assert stats.count == 4
    stats.add_batch(torch.randn(3, 3, 10))
    assert stats.count == 13


@pytest.mark.parametrize("padding,shapes,counts", [
    (0, [(10, 3, 3), (5, 10, 3, 3), (10, 7, 7)], [1, 6, 31]),
    (1, [(10, 3, 3), (5, 10, 3, 3), (10, 5, 5)], [9, 54, 79])])
def test_conv2d_counts(padding, shapes, counts):
    stats = Sleekit(nn.Conv2d(10, 5, 3, padding=padding))
    for shape, count in zip(shapes, counts):
        stats.add_batch(torch.randn(*shape))
        assert stats.count == count


def test_conv1d_counts():
    stats = Sleekit(nn.Conv1d(10, 5, 3))
    for shape, count in (((10, 3), 1), ((5, 10, 3), 6), ((10, 7), 11)):
        stats.add_batch(torch.randn(*shape))
        assert stats.count == count


def test_hessian_matches_manual_and_jax():
    layer = nn.Linear(6, 4)
    stats, jstats = Sleekit(layer), JSleekit(layer)
    x = torch.randn(8, 6)
    stats.add_batch(x)
    jstats.add_batch(x)
    xs = x.numpy().T  # (features, samples)
    assert stats.device == stats.hessian.device == torch.device("cpu")
    np.testing.assert_allclose(stats.hessian.numpy(), xs @ xs.T / 8,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stats.mean.numpy(), xs.mean(axis=1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stats.hessian.numpy(), jstats.hessian.numpy(),
                               rtol=1e-6, atol=1e-7)


LAYERS = {
    "linear": (lambda: nn.Linear(10, 5), (20, 10)),
    "conv1d": (lambda: nn.Conv1d(10, 5, 3), (20, 10, 5)),
    "conv2d": (lambda: nn.Conv2d(10, 5, 3, padding=1), (20, 10, 5, 5)),
}


@pytest.mark.parametrize("kind,preset", [("linear", "basic"),
                                         ("linear", "light"),
                                         ("conv1d", "light"),
                                         ("conv2d", "light")])
def test_quantize_in_place_matches_jax(kind, preset):
    """Two copies of a layer, each with a forward hook feeding its Sleekit
    (the port's on one, JAX's on the other), run the same two batches and
    quantize with the same preset: the port writes into the layer's own
    weight and bias tensors, on the 8-point per-channel grid, with JAX's
    codewords (the weights within 1e-5 of the largest: a codeword apart
    would be a grid step, about 0.05 of it) and JAX's bias."""
    torch.manual_seed(0)
    make, shape = LAYERS[kind]
    layer = make()
    jlayer = copy.deepcopy(layer)
    before = layer.weight.detach().clone()
    weight, bias = layer.weight, layer.bias
    stats, jstats = Sleekit(layer), JSleekit(jlayer)
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, s=s: s.add_batch(inp[0].data, out.data))
        for m, s in ((layer, stats), (jlayer, jstats))]
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _ in range(2):
            x = torch.randn(*shape, generator=g)
            layer(x)
            jlayer(x)
    for h in hooks:
        h.remove()
    assert stats.count == jstats.count
    method = {"basic": "quantize_basic", "light": "quantize_sleekit_light"}
    getattr(stats, method[preset])(3)
    getattr(jstats, method[preset])(3)
    assert layer.weight is weight and layer.bias is bias
    assert not torch.equal(layer.weight, before)
    w = layer.weight.detach()
    scale = float(jlayer.weight.detach().abs().max())
    np.testing.assert_allclose(w.numpy(), jlayer.weight.detach().numpy(),
                               rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(layer.bias.detach().numpy(),
                               jlayer.bias.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    for row in w.flatten(1).numpy():
        assert len(np.unique(np.round(row / (np.abs(row).max() + 1e-12),
                                      5))) <= 8
    stats.free()
    assert stats.layer is None and stats.count == 0


def test_hf_conv1d_transposed():
    """transformers' ``Conv1D`` (weight stored (in, out)) gives the
    statistics of the equivalent ``nn.Linear`` and quantizes to its
    weights, transposed."""
    os.environ.setdefault("USE_TF", "0")
    pytest.importorskip("transformers")
    from transformers.pytorch_utils import Conv1D

    torch.manual_seed(0)
    layer = Conv1D(5, 10)  # weight stored (in=10, out=5)
    ref = nn.Linear(10, 5)
    with torch.no_grad():
        ref.weight.copy_(layer.weight.t())
        ref.bias.copy_(layer.bias)
    x = torch.randn(20, 10)
    a, b = Sleekit(layer), Sleekit(ref)
    a.add_batch(x)
    b.add_batch(x)
    assert a.count == b.count == 20
    np.testing.assert_allclose(a.hessian.numpy(), b.hessian.numpy(),
                               rtol=1e-5, atol=1e-6)
    a.quantize_basic(3)
    b.quantize_basic(3)
    assert layer.weight.shape == (10, 5)
    np.testing.assert_allclose(layer.weight.detach().numpy(),
                               ref.weight.detach().numpy().T,
                               rtol=1e-4, atol=1e-5)


def test_export_pt_roundtrip(tmp_path):
    """The reference default writes ``.pt`` files; ``npy_format=True``
    the ``.npy`` layout."""
    layer = nn.Linear(6, 4)
    stats = Sleekit(layer)
    stats.add_batch(torch.randn(8, 6))
    stats.export(str(tmp_path))
    w = torch.load(tmp_path / "weight.pt")
    h = torch.load(tmp_path / "hessian.pt")
    np.testing.assert_array_equal(w.numpy(), layer.weight.detach().numpy())
    np.testing.assert_array_equal(h.numpy(), stats.hessian.numpy())
    stats.export(str(tmp_path / "npy"), npy_format=True)
    np.testing.assert_array_equal(np.load(tmp_path / "npy" / "mean.npy"),
                                  stats.mean.numpy())
    with pytest.raises(ValueError, match="Unsupported layer type"):
        Sleekit(nn.ReLU())
