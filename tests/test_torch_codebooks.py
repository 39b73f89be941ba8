"""The port's table ``Codebook`` against the JAX package's: the same values
and thresholds, indices, values and up/down neighbours on the same data
(mirrors tests/test_codebooks.py:50,65,73,99)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook

CODEBOOKS = {
    "nf4": lambda cb: cb.nf4(),
    "unsorted": lambda cb: cb.create([0.3, -1.0, 2.0, 0.0, -0.25]),
    "limits": lambda cb: cb.create([-1.0, 0.0, 2.0], [-0.9, 1.5]),
    "ternary": lambda cb: cb.create([-1.0, 0.0, 1.0]),
    "uniform9": lambda cb: cb.uniform(9, -2.0, 2.0),
}


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
