"""The port's codebooks against the JAX package's: the same values and
thresholds, indices, values and up/down neighbours on the same data
(mirrors tests/test_codebooks.py:50,65,73,99), and the training half
(metrics, Lloyd-Max rounds, the constructors from data) within 1e-6."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.codebooks import lloyd_max as j_lloyd_max
from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook, lloyd_max

CODEBOOKS = {
    "nf4": lambda cb: cb.nf4(),
    "unsorted": lambda cb: cb.create([0.3, -1.0, 2.0, 0.0, -0.25]),
    "limits": lambda cb: cb.create([-1.0, 0.0, 2.0], [-0.9, 1.5]),
    "ternary": lambda cb: cb.create([-1.0, 0.0, 1.0]),
    "uniform9": lambda cb: cb.uniform(9, -2.0, 2.0),
}

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", list(CODEBOOKS))
def test_codebook_matches_jax(name):
    """create (sorting, midpoints or given limits), nf4 and uniform give
    JAX's values and thresholds; quantize_index (searchsorted right,
    uint8), quantize_value/up/down and __call__ agree on data that hits
    every bin, the thresholds themselves and both saturating ends."""
    j, t = CODEBOOKS[name](JCodebook), CODEBOOKS[name](Codebook)
    np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    np.testing.assert_array_equal(t.thresholds.numpy(),
                                  np.asarray(j.thresholds))
    assert len(t) == len(j)
    assert t.min() == float(j.min()) and t.max() == float(j.max())
    rng = np.random.RandomState(len(name))
    data = np.concatenate([
        rng.uniform(-3, 3, 300), np.asarray(j.thresholds),
        [-50.0, 50.0]]).astype(np.float32).reshape(1, -1)
    jd, td = jnp.asarray(data), torch.from_numpy(data)
    idx = t.quantize_index(td)
    assert idx.dtype == torch.uint8 and idx.shape == data.shape
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(j.quantize_index(jd)))
    for fn in ("quantize_value", "quantize_up", "quantize_down", "__call__"):
        np.testing.assert_array_equal(getattr(t, fn)(td).numpy(),
                                      np.asarray(getattr(j, fn)(jd)),
                                      err_msg=fn)


def test_generic_matches_uniform_and_check():
    """Codebook.uniform agrees with UniformCodebook on its grid; check()
    refuses unsorted values and thresholds outside their bins."""
    ucb, gcb = UniformCodebook(9, -2.0, 2.0), Codebook.uniform(9, -2.0, 2.0)
    data = torch.from_numpy(
        np.random.RandomState(1).uniform(-3, 3, (200,)).astype(np.float32))
    np.testing.assert_allclose(ucb(data).numpy(), gcb(data).numpy(),
                               atol=1e-6)
    assert torch.equal(ucb.quantize_index(data), gcb.quantize_index(data))
    with pytest.raises(ValueError):
        Codebook.create([0.0, 1.0, 2.0], [1.5, 0.5])
    with pytest.raises(ValueError):
        Codebook.create([0.0, 0.0, 1.0])


def _close(got, want, what=""):
    """The training half's tolerance: 1e-6 (f32 sums and logs in another
    order)."""
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=1e-6, err_msg=what)


def _data(seed=0, n=3000):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("name", ["nf4", "limits", "ternary"])
def test_codebook_metrics_and_rounds_match_jax(name):
    """probabilities, entropy, mse and centroids, one improve round (plain
    and with lagrange_mult) and close_to agree with the JAX package's; so
    do centroids and remove_unused with an empty last bin (data left of
    the last threshold only)."""
    j, t = CODEBOOKS[name](JCodebook), CODEBOOKS[name](Codebook)
    data = _data(len(name))
    jd, td = jnp.asarray(data), torch.from_numpy(data)
    for fn in ("probabilities", "entropy", "mse", "centroids"):
        _close(getattr(t, fn)(td).numpy(), getattr(j, fn)(jd), fn)
    for lm in (0.0, 0.05):
        ji, ti = j.improve(jd, lm), t.improve(td, lm)
        _close(ti.values.numpy(), ji.values, f"improve {lm}")
        _close(ti.thresholds.numpy(), ji.thresholds, f"improve {lm}")
        assert ti.close_to(t) == ji.close_to(j)
    sparse = np.minimum(data, np.asarray(j.thresholds)[-1] - 0.01)
    jd, td = jnp.asarray(sparse), torch.from_numpy(sparse)
    _close(t.centroids(td).numpy(), j.centroids(jd), "empty-bin centroids")
    jr, tr = j.remove_unused(jd), t.remove_unused(td)
    assert len(tr) == len(jr) == len(j) - 1
    _close(tr.values.numpy(), jr.values)
    _close(tr.thresholds.numpy(), jr.thresholds)


@pytest.mark.parametrize("kw", [
    dict(), dict(sample_count=100, seed=3), dict(random_init=True, seed=2),
    dict(lagrange_mult=0.02, max_iter=20)], ids=str)
def test_lloyd_max_matches_jax(kw):
    """lloyd_max (equiprobable or random start, numpy's sample draw,
    entropy-penalized rounds) trains the JAX package's codebook."""
    data = _data(7).reshape(60, 50)
    j, t = j_lloyd_max(data, 8, **kw), lloyd_max(data, 8, **kw)
    assert len(t) == len(j)
    _close(t.values.numpy(), j.values)
    _close(t.thresholds.numpy(), j.thresholds)
    # A tensor trains as its array does.
    t2 = lloyd_max(torch.from_numpy(data), 8, **kw)
    np.testing.assert_array_equal(t2.values.numpy(), t.values.numpy())


def test_random_and_equiprobable_match_jax():
    """Codebook.random (numpy's draw over the distinct values) and
    Codebook.equiprobable (np.array_split's bins, ragged) agree."""
    data = np.round(_data(9, 1001), 1)     # repeated values
    for k in (4, 7):
        _close(Codebook.random(data, k, seed=5).values.numpy(),
               JCodebook.random(data, k, seed=5).values)
        je, te = JCodebook.equiprobable(data, k), Codebook.equiprobable(
            data, k)
        _close(te.values.numpy(), je.values)
        _close(te.thresholds.numpy(), je.thresholds)


def test_uniform_up_down_match_jax():
    """UniformCodebook.quantize_up/down: one grid step up or down from the
    nearest value, saturating at the ends, as the JAX package's."""
    data = np.concatenate([_data(11, 500) * 2, [-5.0, 5.0, 1.0, -1.0]])
    data = data.astype(np.float32)
    j, t = JUniform(8, -1.0, 1.0), UniformCodebook(8, -1.0, 1.0)
    for fn in ("quantize_up", "quantize_down"):
        np.testing.assert_array_equal(
            getattr(t, fn)(torch.from_numpy(data)).numpy(),
            np.asarray(getattr(j, fn)(jnp.asarray(data))), err_msg=fn)
