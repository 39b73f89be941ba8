"""The port's GPTQ solver against the JAX package's on the same
numpy-seeded inputs (mirrors tests/test_solver.py:82-170).

Tolerances: the quantized weights must pick the same codewords (equal
codebook indices) and agree in value within 1e-6 of their largest entry
(``same_codewords``); errors within 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu import solver as js
from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.hessian import dampen as j_dampen
from sleekit_tpu.hessian import hessian_inv_chol as j_inv_chol
from sleekit_tpu_torch import solver as ts
from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread, quant_problem, same_codewords)

QUANTIZERS = {
    "uniform4": (JUniform(16, -1.0, 1.0), UniformCodebook(16, -1.0, 1.0)),
    "nf4": (JCodebook.nf4(), Codebook.nf4()),
}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_channelwise_error_matches_jax():
    W, H = quant_problem(16, 40, 0)
    Q = np.round(W * 2) / 2
    want = np.asarray(js.channelwise_error(*map(jnp.asarray, (W, Q, H))))
    got = ts.channelwise_error(*map(torch.from_numpy, (W, Q, H))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(ts.quantization_error(*map(torch.from_numpy, (W, Q, H)))
                 ) == pytest.approx(float(want.mean()), rel=1e-5)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("mode", js.ORDER_MODES)
def test_orders_match_jax(mode, ties):
    """Every column ordering is the JAX package's permutation. With ties
    (duplicated weight columns over a diagonal Hessian with repeated
    entries) the stable sort keeps tied columns in order, as
    jnp.argsort."""
    W, H = quant_problem(12, 24, 1)
    if ties:
        W[:, 12:] = W[:, :12]
        H = np.diag(np.tile(np.float32([2.0, 1.0, 3.0, 1.0]), 6))
    H = H + np.eye(24, dtype=np.float32)
    jcb, tcb = QUANTIZERS["uniform4"]
    want = np.asarray(js.compute_order(jnp.asarray(W), jnp.asarray(H), jcb,
                                       mode))
    got = ts.compute_order(torch.from_numpy(W), torch.from_numpy(H), tcb,
                           mode).numpy()
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(24))


def test_unknown_order_raises():
    with pytest.raises(ValueError, match="act_order"):
        ts.compute_order(torch.ones(2, 2), torch.eye(2),
                         QUANTIZERS["nf4"][1], "bogus")


@pytest.mark.parametrize("m,n,block", [(32, 64, 16), (48, 200, 128)],
                         ids=["blocks", "ragged"])
@pytest.mark.parametrize("quantizer", list(QUANTIZERS))
def test_gptq_sweep_matches_jax(m, n, block, quantizer):
    """The blocked sweep (n = 200 against block 128: a ragged last block,
    which the JAX package pads) picks the JAX package's codewords."""
    W, H = quant_problem(m, n, 2)
    Hinv = np.asarray(j_inv_chol(j_dampen(jnp.asarray(H), 0.01)))
    jcb, tcb = QUANTIZERS[quantizer]
    W = W * 0.4
    want = js.gptq_sweep(jnp.asarray(W), jnp.asarray(Hinv), jcb,
                         block_size=block)
    got = ts.gptq_sweep(torch.from_numpy(W), torch.from_numpy(Hinv.copy()),
                        tcb, block_size=block)
    same_codewords(got, want, tcb)


@pytest.mark.parametrize("kw", [
    dict(act_order="diag"), dict(act_order="sqerr", damp=0.03),
    dict(act_order="none", damp_retry=False),
    dict(act_order="sqerr", nb_ls_moves=10)], ids=str)
def test_quantize_opt_matches_jax(kw):
    """quantize_opt (dampen, order, permute, inverse factor, sweep,
    un-permute, local search) picks the JAX package's codewords."""
    W, H = quant_problem(32, 96, 3)
    jcb, tcb = QUANTIZERS["uniform4"]
    W = W * 0.4
    want = js.quantize_opt(jnp.asarray(W), jnp.asarray(H), jcb, **kw)
    got = ts.quantize_opt(torch.from_numpy(W), torch.from_numpy(H), tcb,
                          **kw)
    same_codewords(got, want, tcb)
    # And it beats rounding to nearest on the objective.
    tW, tH = torch.from_numpy(W), torch.from_numpy(H)
    assert ts.quantization_error(tW, got, tH) < ts.quantization_error(
        tW, tcb(tW), tH)


def test_quantize_opt_rank_deficient_matches_jax():
    """H = [[D, D], [D, D]] (D diagonal squares, rank 16 of 32, pivots
    exactly 0): at damp 1e-9 both packages' factorizations fail and retry
    at the same multiplier, and the port picks the JAX package's
    codewords."""
    d = np.diag(np.tile(np.float32([1, 4, 9, 16]), 4))
    H = np.block([[d, d], [d, d]]).astype(np.float32)
    W = (np.random.default_rng(5).standard_normal((24, 32)) * 0.4).astype(
        np.float32)
    jcb, tcb = QUANTIZERS["uniform4"]
    want = js.quantize_opt(jnp.asarray(W), jnp.asarray(H), jcb, damp=1e-9)
    got = ts.quantize_opt(torch.from_numpy(W), torch.from_numpy(H), tcb,
                          damp=1e-9)
    same_codewords(got, want, tcb)


def test_quantize_opt_near_singular():
    """The JAX test's near-singular case (a rank-2 Hessian of size 100,
    damp 1e-6): finite, and its objective under 1e-3 of rounding to
    nearest's, as the JAX package's is. Q is not compared: whether the
    first factorization of this matrix succeeds depends on the LAPACK
    (PyTorch's factors it, the JAX package's does not and retries), and
    the sweep over a factor this ill-conditioned amplifies any difference
    (ROADMAP, faults)."""
    W, H = quant_problem(16, 100, 4, rank=2)
    jcb, tcb = QUANTIZERS["uniform4"]
    W = W * 0.4
    tW, tH = torch.from_numpy(W), torch.from_numpy(H)
    rtn = float(ts.quantization_error(tW, tcb(tW), tH))
    want = torch.from_numpy(np.array(js.quantize_opt(
        jnp.asarray(W), jnp.asarray(H), jcb, damp=1e-6)))
    got = ts.quantize_opt(tW, tH, tcb, damp=1e-6)
    assert torch.isfinite(got).all()
    for q in (got, want):
        assert float(ts.quantization_error(tW, q, tH)) < 1e-3 * rtn
    with pytest.raises(ValueError, match="quantize_opt takes"):
        ts.quantize_opt(tW, tH[:5, :5], tcb)
