"""The port's native packing library (``sleekit_tpu_torch/native``) against
the JAX package's (``sleekit_tpu/native``) and the port's ``ops/pack.py``:
words bit for bit, the unpack round trip, the fused quantize + pack, its
build under the port's ``_build/``, and a failed build raising (no numpy
fallback)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu import native as jnative
from sleekit_tpu.ops.pack import pack_indices as j_pack_indices
from sleekit_tpu_torch import native
from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.ops.pack import pack_indices, unpack_indices

PACK_WIDTHS = [1, 2, 3, 4, 8]


@pytest.mark.parametrize("nbits", PACK_WIDTHS)
@pytest.mark.parametrize("k,n", [(123, 57), (320, 8), (7, 1)])
def test_pack_matches_jax_and_ops_pack(nbits, k, n):
    """The native words equal the JAX package's ``pack_indices_np`` and
    both packages' 'linear' ``pack_indices``, bit for bit; the plain
    version's too; both unpacks give the indices back."""
    rng = np.random.RandomState(nbits + k)
    idx = rng.randint(0, 2 ** nbits, (k, n)).astype(np.uint8)
    words = native.pack_indices_np(idx, nbits)
    assert words.dtype == np.int32
    np.testing.assert_array_equal(words, jnative.pack_indices_np(idx, nbits))
    np.testing.assert_array_equal(
        words, pack_indices(torch.from_numpy(idx.astype(np.int64)),
                            nbits).numpy())
    np.testing.assert_array_equal(
        words, np.asarray(j_pack_indices(jnp.asarray(idx.astype(np.int32)),
                                         nbits)))
    np.testing.assert_array_equal(words, native.pack_indices_plain(idx,
                                                                   nbits))
    for back in (native.unpack_indices_np(words, nbits, k),
                 native.unpack_indices_plain(words, nbits, k),
                 unpack_indices(torch.from_numpy(words), nbits, k).numpy()):
        assert back.dtype == np.int32
        np.testing.assert_array_equal(back, idx.astype(np.int32))


@pytest.mark.parametrize("nbits", [0, 5, 6, 7, 9])
def test_unsupported_widths_raise(nbits):
    """Widths the packed format has no layout for raise, as ``ops/pack.py``
    does (the JAX package's numpy fallback packs 5-7 bits into words no
    kernel reads)."""
    idx = np.zeros((10, 4), np.uint8)
    for fn in (lambda: native.pack_indices_np(idx, nbits),
               lambda: native.pack_indices_plain(idx, nbits),
               lambda: native.unpack_indices_np(np.zeros((2, 4), np.int32),
                                                nbits, 10),
               lambda: native.quantize_pack_uniform_np(
                   idx.astype(np.float32), nbits, 4, 0.5, 0.0)):
        with pytest.raises(ValueError, match="unsupported pack width"):
            fn()
    if 1 <= nbits <= 8:
        with pytest.raises(ValueError, match="unsupported pack width"):
            pack_indices(torch.from_numpy(idx.astype(np.int64)), nbits)


@pytest.mark.parametrize("nbits", [2, 3, 4, 8])
def test_quantize_pack_uniform_matches_jax(nbits):
    """The fused round-to-grid + pack equals the JAX package's native one
    and the plain version (its arithmetic in numpy), bit for bit, with
    values past both ends of the grid and on its half-steps; its indices
    are the grid's nearest within one step."""
    rng = np.random.RandomState(10 + nbits)
    k, n = 100, 40
    levels = 2 ** nbits
    cb = UniformCodebook(levels, -1.0, 1.0)
    w = rng.uniform(-1.3, 1.3, (k, n)).astype(np.float32)
    half = (cb.zero + cb.scale * (np.arange(levels) + 0.5)).astype(np.float32)
    w.reshape(-1)[:levels] = half
    got = native.quantize_pack_uniform_np(w, nbits, levels, cb.scale,
                                          cb.zero)
    np.testing.assert_array_equal(got, jnative.quantize_pack_uniform_np(
        w, nbits, levels, cb.scale, cb.zero))
    np.testing.assert_array_equal(got, native.quantize_pack_uniform_plain(
        w, nbits, levels, cb.scale, cb.zero))
    idx = native.unpack_indices_np(got, nbits, k)
    near = np.clip(np.round((w - cb.zero) / cb.scale), 0, levels - 1)
    assert np.abs(idx - near).max() <= 1
    with pytest.raises(ValueError, match="levels"):
        native.quantize_pack_uniform_np(w, nbits, 1, cb.scale, cb.zero)


def test_builds_into_the_ports_build_dir():
    """The library lives under ``sleekit_tpu_torch/_build`` with a hashed
    name, and loads once a process."""
    path = native.library_path("packing.cpp")
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "sleekit_tpu_torch"
    assert native.get_lib() is native.get_lib()
    assert path.exists()


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that is missing, or that fails, raises with
    its message, and the library is not loaded."""
    monkeypatch.setenv("CXX", str(tmp_path / "missing-c++"))
    with pytest.raises(RuntimeError, match="building packing.cpp failed"):
        native.get_lib()
    failing = tmp_path / "failing-c++"
    failing.write_text("#!/bin/sh\necho 'boom: no compiler here' >&2\n"
                       "exit 1\n")
    os.chmod(failing, 0o755)
    monkeypatch.setenv("CXX", str(failing))
    with pytest.raises(RuntimeError, match="boom: no compiler here"):
        native.pack_indices_np(np.zeros((8, 2), np.uint8), 4)
    assert not native.library_path("packing.cpp").exists()
