"""The port's local search against the JAX package's on the same
numpy-seeded inputs (mirrors tests/test_local_search.py): the gains
within 1e-5, and the refined weights on the same codewords (values
within 1e-6 of the largest) with the objective within 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu import local_search as jls
from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu_torch import local_search as tls
from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook
from sleekit_tpu_torch.solver import quantization_error

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread, quant_problem, same_codewords)

QUANTIZERS = {
    "uniform3": (JUniform(8, -1.0, 1.0), UniformCodebook(8, -1.0, 1.0)),
    "nf4": (JCodebook.nf4(), Codebook.nf4()),
}

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_compute_gain_matches_jax():
    """The closed-form gain of every single-entry candidate (here: each
    entry one grid step up) within 1e-5 of the JAX package's and of the
    objective's difference computed directly."""
    W, H = quant_problem(6, 20, 0)
    jcb, tcb = QUANTIZERS["uniform3"]
    W = W * 0.4
    Q = tcb(torch.from_numpy(W))
    C = tcb.quantize_up(Q)
    tW, tH = torch.from_numpy(W), torch.from_numpy(H)
    got = tls.compute_gain(tW, Q, tH, C)
    want = np.asarray(jls.compute_gain(*map(jnp.asarray, (
        W, Q.numpy(), H, C.numpy()))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # One candidate applied alone moves the objective by its gain.
    Q2 = Q.clone()
    Q2[2, 5] = C[2, 5]
    delta = (quantization_error(tW, Q, tH) - quantization_error(tW, Q2, tH)
             ) * W.shape[0]
    assert float(delta) == pytest.approx(float(got[2, 5]), rel=1e-4,
                                         abs=1e-6)


@pytest.mark.parametrize("moves", [1, 25])
@pytest.mark.parametrize("quantizer", list(QUANTIZERS))
def test_local_search_matches_jax(quantizer, moves):
    """``moves`` rounds of per-row best flips from the round-to-nearest
    start: the JAX package's codewords, and the objective within 1e-5;
    the search never makes it worse."""
    W, H = quant_problem(16, 48, 1)
    jcb, tcb = QUANTIZERS[quantizer]
    W = W * 0.4
    tW, tH = torch.from_numpy(W), torch.from_numpy(H)
    Q0 = tcb(tW)
    want = np.asarray(jls.quantize_local_search(
        jnp.asarray(W), jnp.asarray(Q0.numpy()), jnp.asarray(H), jcb,
        moves))
    got = tls.quantize_local_search(tW, Q0, tH, tcb, moves)
    same_codewords(got, want, tcb)
    e_got = float(quantization_error(tW, got, tH))
    assert e_got == pytest.approx(float(quantization_error(
        tW, torch.from_numpy(want), tH)), rel=1e-5)
    assert e_got < float(quantization_error(tW, Q0, tH))
    assert tls.quantize_local_search(tW, Q0, tH, tcb, 0) is Q0
