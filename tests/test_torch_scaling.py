"""The port's scaling searches against the JAX package's on the same
numpy-seeded inputs (mirrors tests/test_scaling.py): the factor grid bit
for bit, every ``compute_scaling`` mode within 1e-6 (another grid factor
would differ by a grid step, about 1%), and the scaled solves on the same
codewords."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu import scaling as jsc
from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu_torch import scaling as tsc
from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread, quant_problem, same_codewords)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("lo,hi,num", [(0.05, 1.0, 100), (0.05, 1.0, 16),
                                       (-0.0633, 0.0633, 16),
                                       (0.1, 0.9, 37)])
def test_grid_factors_bit_identical(lo, hi, num):
    """grid_factors is the f32 grid of jnp.linspace(lo, hi, num) as the
    JAX package's compiled search computes it (constant bounds under jit,
    as in compute_min_mse_scaling / compute_obq_scaling), bit for bit;
    (-0.0633, 0.0633, 16) is a refine offset grid. torch.linspace differs
    in the last bit of some factors, which would move the chosen scale."""
    want = np.asarray(jax.jit(
        lambda: jnp.linspace(lo, hi, num, dtype=jnp.float32))())
    got = tsc.grid_factors(lo, hi, num)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if num == 100:
        assert not np.array_equal(
            torch.linspace(lo, hi, num, dtype=torch.float32).numpy(), want)


CODEBOOKS = {
    "uniform4": (JUniform(16, -1.0, 1.0), UniformCodebook(16, -1.0, 1.0)),
    "nf4": (JCodebook.nf4(), Codebook.nf4()),
}


@pytest.mark.parametrize("mode", ["mse", "max", "norm", "diag", "diag5",
                                  "hessian", "hessian3", "obq"])
def test_compute_scaling_matches_jax(mode):
    """Every mode (the diag/hessian suffix adds P% dampening; obq on a
    6-factor grid) gives the JAX package's per-channel scales within 1e-6,
    for a uniform and a table codebook."""
    W, H = quant_problem(24, 64, 0)
    kw = dict(grid_size=6) if mode == "obq" else {}
    for name, (jcb, tcb) in CODEBOOKS.items():
        want = np.asarray(jsc.compute_scaling(jnp.asarray(W), jcb,
                                              jnp.asarray(H), mode=mode,
                                              **kw))
        got = tsc.compute_scaling(torch.from_numpy(W), tcb,
                                  torch.from_numpy(H), mode=mode, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   err_msg=f"{mode} {name}")
    with pytest.raises(ValueError, match="Unknown scaling mode"):
        tsc.compute_scaling(torch.from_numpy(W), tcb, None, mode="bogus")


def test_obq_refine_and_axis_match_jax():
    """The coarse-then-fine obq search (refine 4: per-channel fine
    factors) and the mse search along axis 1 agree with the JAX
    package's within 1e-6."""
    W, H = quant_problem(16, 48, 1)
    jcb, tcb = CODEBOOKS["uniform4"]
    want = np.asarray(jsc.compute_obq_scaling(jnp.asarray(W), jcb, 0,
                                              jnp.asarray(H), refine=4))
    got = tsc.compute_obq_scaling(torch.from_numpy(W), tcb, 0,
                                  torch.from_numpy(H), refine=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    want = np.asarray(jsc.compute_min_mse_scaling(jnp.asarray(W), jcb,
                                                  axis=1, grid_size=16))
    got = tsc.compute_min_mse_scaling(torch.from_numpy(W), tcb, axis=1,
                                      grid_size=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_scaled_solves_match_jax():
    """apply_scaling, compute_norm_scaling and quantize_with_scaling
    (rounding without H, GPTQ with it) agree with the JAX package's."""
    W, H = quant_problem(16, 40, 2)
    jcb, tcb = CODEBOOKS["uniform4"]
    tW, tH = torch.from_numpy(W), torch.from_numpy(H)
    scale = tsc.compute_norm_scaling(tW, 0)
    np.testing.assert_allclose(
        scale.numpy(), np.asarray(jsc.compute_norm_scaling(jnp.asarray(W))),
        rtol=1e-6)
    cols = np.linspace(0.5, 2.0, 40, dtype=np.float32)
    np.testing.assert_array_equal(
        tsc.apply_scaling(tW, torch.from_numpy(cols), axis=1).numpy(),
        np.asarray(jsc.apply_scaling(jnp.asarray(W), jnp.asarray(cols), 1)))
    s = scale * 3
    js_ = jnp.asarray(s.numpy())
    for h in (None, H):
        want = jsc.quantize_with_scaling(
            jnp.asarray(W), js_, jcb, H=None if h is None else jnp.asarray(h))
        got = tsc.quantize_with_scaling(
            tW, s, tcb, H=None if h is None else tH)
        same_codewords(got / s[:, None], np.asarray(want) / s.numpy()[:, None],
                       tcb)
