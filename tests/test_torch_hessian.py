"""The port's Hessian statistics and transforms against the JAX package's
on the same numpy-seeded inputs (mirrors tests/test_pipeline.py:19-70 and
tests/test_solver.py:46-156)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu import hessian as jh
from sleekit_tpu_torch import hessian as th

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol, what=""):
    """Relative to the largest |want|: f32 products summed in another
    order."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def test_update_stats_matches_jax():
    """Four batches of different sizes through update_stats (the
    reference's renormalization order): mean, Hessian and count within
    1e-5 of the JAX package's."""
    n = 48
    js, ts = jh.init_stats(n), th.init_stats(n, device="cpu")
    rng = _rng(0)
    for rows in (7, 64, 1, 30):
        x = (rng.standard_normal((rows, n)) + 0.5).astype(np.float32)
        js = jh.update_stats(js, jnp.asarray(x))
        ts = th.update_stats(ts, torch.from_numpy(x))
    assert float(ts.count) == float(js.count) == 102.0
    _close(ts.mean.numpy(), js.mean, 1e-5, "mean")
    _close(ts.hessian.numpy(), js.hessian, 1e-5, "hessian")
    with pytest.raises(ValueError):
        th.update_stats(ts, torch.zeros(2, 3, n))


@pytest.mark.parametrize("kind,args", [
    ("conv2d", dict(kernel_size=(3, 2), dilation=(2, 1), padding=(1, 0),
                    stride=(1, 2))),
    ("conv2d", dict(kernel_size=(2, 2))),
    ("conv1d", dict(kernel_size=3, dilation=2, padding=1, stride=2)),
], ids=["conv2d-dilated", "conv2d", "conv1d"])
def test_conv_unfolds_match_jax(kind, args):
    """The conv input unfolds (F.unfold's feature order, which the JAX
    package reproduces) give the JAX package's patch rows within 1e-5."""
    shape = (2, 3, 7, 8) if kind == "conv2d" else (2, 3, 11)
    x = _rng(1).standard_normal(shape).astype(np.float32)
    jfn = getattr(jh, f"prepare_input_{kind}")
    tfn = getattr(th, f"prepare_input_{kind}")
    want = np.asarray(jfn(jnp.asarray(x), **args))
    got = tfn(torch.from_numpy(x), **args).numpy()
    assert got.shape == want.shape
    _close(got, want, 1e-5)
    # An unbatched input unfolds as a batch of one.
    _close(tfn(torch.from_numpy(x[0]), **args).numpy(),
           jfn(jnp.asarray(x[0]), **args), 1e-5)


def test_hessian_transforms_match_jax():
    """remove_input_bias, remove_dead_values (a dead channel gets the mean
    diagonal, its weight column zeroed) and dampen agree with the JAX
    package's within 1e-6."""
    rng = _rng(2)
    a = rng.standard_normal((20, 12)).astype(np.float32)
    H = a.T @ a
    H[3, :] = H[:, 3] = 0.0
    mu = rng.standard_normal(12).astype(np.float32)
    W = rng.standard_normal((5, 12)).astype(np.float32)
    tH, tmu, tW = map(torch.from_numpy, (H, mu, W))
    _close(th.remove_input_bias(tH, tmu).numpy(),
           jh.remove_input_bias(jnp.asarray(H), jnp.asarray(mu)), 1e-6)
    (jH2, jW2), (tH2, tW2) = (jh.remove_dead_values(jnp.asarray(H),
                                                    jnp.asarray(W)),
                              th.remove_dead_values(tH, tW))
    _close(tH2.numpy(), jH2, 1e-6)
    np.testing.assert_array_equal(tW2.numpy(), np.asarray(jW2))
    assert float(tH2[3, 3]) > 0 and not tW2[:, 3].any()
    for damp in (0.01, 0.3):
        _close(th.dampen(tH, damp).numpy(), jh.dampen(jnp.asarray(H), damp),
               1e-6)


@pytest.mark.parametrize("n", [1, 33, 200])
def test_hessian_inv_chol_matches_jax(n):
    """The upper Cholesky factor of H⁻¹ (flip, cholesky, one triangular
    solve, flip) agrees with the JAX package's within 1e-5 of its largest
    entry, and Uᵀ U = H⁻¹ (GPTQ's upper Cholesky factor of H⁻¹)."""
    rng = _rng(n)
    a = rng.standard_normal((n, 2 * n + 4)).astype(np.float32)
    H = a @ a.T / n + np.eye(n, dtype=np.float32)
    want = np.asarray(jh.hessian_inv_chol(jnp.asarray(H)))
    got = th.hessian_inv_chol(torch.from_numpy(H)).numpy()
    _close(got, want, 1e-5)
    assert np.allclose(np.triu(got), got)
    _close(got.T @ got, np.linalg.inv(H.astype(np.float64)), 1e-4)


@pytest.mark.parametrize("damp", [1e-9, 1e-6])
def test_robust_inverse_on_rank_deficient_hessian(damp):
    """H = [[D, D], [D, D]] (D diagonal squares: rank 16 of 32, pivots
    exactly 0): at damp 1e-9 (below an f32 step of the diagonal) the
    factorization fails (torch's info > 0, JAX's NaN) and retries at
    max(10x, 1e-4); at 1e-6 it succeeds. The port returns the JAX
    package's multiplier and a finite factor within 1e-5 of its."""
    d = np.diag(np.tile(np.float32([1, 4, 9, 16]), 4))
    H = np.block([[d, d], [d, d]]).astype(np.float32)
    jinv, jmult = jh.hessian_inv_chol_robust(jnp.asarray(H), damp)
    tinv, tmult = th.hessian_inv_chol_robust(torch.from_numpy(H), damp)
    assert tmult == float(jmult) == (1e5 if damp == 1e-9 else 1.0)
    assert torch.isfinite(tinv).all()
    _close(tinv.numpy(), jinv, 1e-5)
    first = th.hessian_inv_chol(th.dampen(torch.from_numpy(H), damp))
    assert bool(torch.isfinite(first).all()) == (damp == 1e-6)


def test_random_psd_matrix_and_stats_from_numpy():
    """random_psd_matrix: A Aᵀ from numpy's seed, symmetric PSD of the
    given rank, the rows' norms times damp added on the diagonal;
    stats_from_numpy builds f32 statistics from arrays."""
    h = th.random_psd_matrix(3, 16, 4, device="cpu")
    assert torch.equal(h, th.random_psd_matrix(3, 16, 4, device="cpu"))
    assert torch.allclose(h, h.T)
    ev = torch.linalg.eigvalsh(h.double())
    assert ev.min() > -1e-4 and int((ev > 1e-3).sum()) == 4
    hd = th.random_psd_matrix(3, 16, 4, damp=0.1, device="cpu")
    assert torch.allclose(torch.diagonal(hd - h),
                          0.1 * torch.linalg.vector_norm(h, dim=1))
    st = th.stats_from_numpy(np.ones(4), np.eye(4, dtype=np.float64), 7,
                             device="cpu")
    assert st.hessian.dtype == st.mean.dtype == st.count.dtype == torch.float32
    assert float(st.count) == 7.0 and st.hessian.shape == (4, 4)
