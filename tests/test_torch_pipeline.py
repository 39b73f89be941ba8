"""The port's layer pipeline against the JAX package's on the same
numpy-seeded inputs (mirrors tests/test_pipeline.py): ``quantize_layer``
for every preset and codebook kind on the same codewords (values within
1e-6 of the largest), scales within 1e-6, errors within 1e-5; the
``LayerQuantizer`` statistics of each layer kind; and artifact
directories crossing between the packages in both directions."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu import pipeline as jp
from sleekit_tpu_torch import pipeline as tp

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread, quant_problem, same_codewords)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _mean_and_hessian(n, seed):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((3 * n, n)) + 0.4).astype(np.float32)
    return X.mean(0).astype(np.float32), (X.T @ X / len(X)).astype(
        np.float32)


def test_presets_match_jax():
    """The same presets (heavy: 100 moves) and QuantConfig fields."""
    assert tp.PRESETS == jp.PRESETS
    assert tp.PRESETS["heavy"]["nb_ls_moves"] == 100
    assert ([f.name for f in dataclasses.fields(tp.QuantConfig)]
            == [f.name for f in dataclasses.fields(jp.QuantConfig)])
    assert (dataclasses.asdict(tp.preset_config("light", 4, grid_size=7))
            == dataclasses.asdict(jp.preset_config("light", 4, grid_size=7)))
    with pytest.raises(ValueError, match="codebook_kind"):
        tp.QuantConfig(codebook_kind="bogus").make_codebook()


@pytest.mark.parametrize("kind,nbits", [("uniform", 3), ("uniform", 4),
                                        ("nf4", 4), ("lloyd", 3)])
@pytest.mark.parametrize("preset", ["basic", "light", "heavy"])
def test_quantize_layer_matches_jax(preset, kind, nbits):
    """quantize_layer (bias correction, scaling search, GPTQ, local
    search, bias delta) returns the JAX package's (Q, bias delta, scale,
    error): Q on the same codewords, the rest within 1e-6 / 1e-5."""
    W, _ = quant_problem(32, 96, 0)
    mu, H = _mean_and_hessian(96, 1)
    jcfg = jp.preset_config(preset, nbits, codebook_kind=kind)
    tcfg = tp.preset_config(preset, nbits, codebook_kind=kind)
    jcb = tcb = None
    if kind != "uniform":
        jcb, tcb = jcfg.make_codebook(jnp.asarray(W)), tcfg.make_codebook(
            torch.from_numpy(W))
        np.testing.assert_allclose(tcb.values.numpy(), np.asarray(jcb.values),
                                   rtol=0, atol=1e-6)
    want = [np.asarray(x) for x in jp.quantize_layer(
        jnp.asarray(W), jnp.asarray(H), jnp.asarray(mu), jcfg, jcb)]
    got = [x.numpy() for x in tp.quantize_layer(
        torch.from_numpy(W), torch.from_numpy(H), torch.from_numpy(mu), tcfg,
        tcb)]
    cb = tcb or tcfg.make_codebook()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, err_msg="scale")
    same_codewords(torch.from_numpy(got[0] / got[2][:, None]),
                   want[0] / want[2][:, None], cb)
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=1e-5 * np.abs(want[1]).max())
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5,
                               atol=1e-7 * np.abs(want[3]).max())


@pytest.mark.parametrize("kind,shape,geo", [
    ("linear", (12, 40), dict()),
    ("conv1d", (6, 4, 3), dict(kernel_size=3, padding=1)),
    ("conv2d", (6, 3, 2, 2), dict(kernel_size=(2, 2), stride=(1, 2))),
])
def test_layer_quantizer_kinds_match_jax(kind, shape, geo):
    """add_batch over two batches (the conv unfolds) gives the JAX
    package's statistics within 1e-5; quantize (light, 4 bits) updates
    the weights (on the JAX package's codewords) and the bias."""
    rng = np.random.default_rng(2)
    W = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[0]).astype(np.float32)
    xs = {"linear": (3, 5, shape[1]), "conv1d": (2, shape[1], 9),
          "conv2d": (2, shape[1], 5, 6)}[kind]
    jq = jp.LayerQuantizer(W, bias=b, kind=kind, **geo)
    tq = tp.LayerQuantizer(W, bias=b, kind=kind, device="cpu", **geo)
    for _ in range(2):
        x = (rng.standard_normal(xs) + 0.2).astype(np.float32)
        jq.add_batch(jnp.asarray(x))
        tq.add_batch(torch.from_numpy(x))
    assert tq.count == jq.count
    for f in ("mean", "hessian"):
        want = np.asarray(getattr(jq.stats, f))
        np.testing.assert_allclose(getattr(tq.stats, f).numpy(), want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())
    jQ, jscale, _ = jq.quantize_sleekit_light(4)
    tQ, tscale, _ = tq.quantize_sleekit_light(4)
    assert tuple(tQ.shape) == shape
    same_codewords(tQ.reshape(shape[0], -1) / tscale[:, None],
                   np.asarray(jQ).reshape(shape[0], -1)
                   / np.asarray(jscale)[:, None],
                   tp.preset_config("light", 4).make_codebook())
    np.testing.assert_allclose(tq.bias.numpy(), np.asarray(jq.bias),
                               rtol=0, atol=1e-5)


def test_artifacts_cross_between_packages(tmp_path):
    """A directory the JAX package's LayerQuantizer.export writes loads in
    the port's LayerQuantizer.load, and the port's export (.npy, and .pt
    with npy_format=False) loads back, with the same arrays; the loaded
    quantizers solve to the same codewords."""
    W, _ = quant_problem(16, 48, 3)
    mu, H = _mean_and_hessian(48, 4)
    bias = np.arange(16, dtype=np.float32)
    jq = jp.LayerQuantizer(W, bias=bias)
    jq.add_batch(jnp.asarray(np.random.default_rng(5).standard_normal(
        (64, 48)).astype(np.float32)))
    jq.export(str(tmp_path / "jax"))
    tq = tp.LayerQuantizer.load(str(tmp_path / "jax"), device="cpu")
    for f in ("mean", "hessian"):
        np.testing.assert_array_equal(getattr(tq.stats, f).numpy(),
                                      np.asarray(getattr(jq.stats, f)))
    np.testing.assert_array_equal(tq.weight.numpy(), W)
    np.testing.assert_array_equal(tq.bias.numpy(), bias)
    tq.export(str(tmp_path / "port"))
    tq.export(str(tmp_path / "port_pt"), npy_format=False)
    back = jp.LayerQuantizer.load(str(tmp_path / "port"))
    pt = tp.LayerQuantizer.load(str(tmp_path / "port_pt"), device="cpu")
    for other in (back, pt):
        np.testing.assert_array_equal(np.asarray(other.stats.hessian),
                                      np.asarray(jq.stats.hessian))
        np.testing.assert_array_equal(np.asarray(other.bias), bias)
    cfg = dict(nbits=3, grid_size=20)
    jQ, jscale, _ = back.quantize_basic(**cfg)
    tQ, tscale, _ = tq.quantize_basic(**cfg)
    same_codewords(tQ / tscale[:, None],
                   np.asarray(jQ) / np.asarray(jscale)[:, None],
                   tp.preset_config("basic", 3).make_codebook())
    tq.free()
    assert tq.weight is None and tq.stats is None
