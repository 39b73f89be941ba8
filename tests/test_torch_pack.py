"""The packed format is a shared contract: the port's words are
bit-identical to the JAX package's (mirrors tests/test_ops.py:152,234)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.ops import pack as jpack
from sleekit_tpu.scaling import compute_non_saturating_scaling as j_nonsat
from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.ops import pack as tpack
from sleekit_tpu_torch.scaling import compute_non_saturating_scaling

from tests._torch_port_util import t


@pytest.mark.parametrize("nbits", range(1, 8))
def test_pair_words_bit_identical(nbits):
    rng = np.random.RandomState(nbits)
    for k in (256, 301, 1000):
        idx = rng.randint(0, 2 ** nbits, (k, 33))
        want = np.asarray(jpack.pack_indices(jnp.asarray(idx), nbits,
                                             layout="pair"))
        got = tpack.pack_indices(torch.from_numpy(idx), nbits, layout="pair")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        back = tpack.unpack_indices(got, nbits, k, layout="pair")
        np.testing.assert_array_equal(back.numpy(), idx)


@pytest.mark.parametrize("nbits", [1, 2, 4, 8])
def test_linear_words_bit_identical(nbits):
    rng = np.random.RandomState(40 + nbits)
    idx = rng.randint(0, 2 ** nbits, (77, 9))
    want = np.asarray(jpack.pack_indices(jnp.asarray(idx), nbits))
    got = tpack.pack_indices(torch.from_numpy(idx), nbits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpack.unpack_indices(got, nbits, 77).numpy(), idx)


def test_int8_words_bit_identical_and_padded():
    rng = np.random.RandomState(21)
    idx = rng.randint(0, 256, (200, 300))
    want = np.asarray(jpack.pack_indices(jnp.asarray(idx), 8, layout="int8"))
    got = tpack.pack_indices(torch.from_numpy(idx), 8, layout="int8")
    assert got.dtype == torch.int8 and tuple(got.shape) == (224, 1024)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tpack.unpack_indices(got, 8, 200, layout="int8")
    np.testing.assert_array_equal(back[:, :300].numpy(), idx)


@pytest.mark.parametrize("layout", ["plane", "pair3", "pair3x"])
def test_unported_layouts_name_their_roadmap_item(layout):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpack.pack_indices(torch.zeros((512, 8), dtype=torch.int64), 3,
                           layout=layout)


@pytest.mark.parametrize("nbits", [4, 8])
def test_pack_quantized_matches_jax(nbits):
    """pack_quantized (affine codebook -> pair / int8) gives the JAX
    package's words, scales and metadata."""
    rng = np.random.RandomState(3 + nbits)
    out_f, in_f = 70, 96
    jcb = JUniform(2 ** nbits, -1.0, 1.0)
    cb = UniformCodebook(2 ** nbits, -1.0, 1.0)
    np.testing.assert_array_equal(cb.values.numpy(), np.asarray(jcb.values))
    w = rng.randn(out_f, in_f).astype(np.float32)
    scale = np.asarray(j_nonsat(jnp.asarray(w), jcb))
    np.testing.assert_array_equal(
        compute_non_saturating_scaling(torch.from_numpy(w), cb).numpy(),
        scale)
    q = np.asarray(jcb(jnp.asarray(w / scale[:, None]))) * scale[:, None]
    bias = rng.randn(out_f).astype(np.float32)
    want = jpack.pack_quantized(jnp.asarray(q), jnp.asarray(scale), jcb,
                                bias=jnp.asarray(bias))
    got = tpack.pack_quantized(t(q), t(scale), cb, bias=t(bias))
    assert (got.layout, got.nbits, got.in_features, got.out_features) == (
        want.layout, want.nbits, want.in_features, want.out_features)
    assert got.affine == want.affine
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias))
    np.testing.assert_allclose(got.dequantize().numpy(),
                               np.asarray(want.dequantize()), rtol=0, atol=0)


def test_concat_packed_matches_jax():
    rng = np.random.RandomState(5)
    cbj = JUniform(16, -1.0, 1.0)
    parts_j, parts_t = [], []
    for n in (32, 16, 16):
        q_idx = rng.randint(0, 16, (64, n))
        lut = np.asarray(cbj.values)
        scale = rng.rand(n).astype(np.float32)
        parts_j.append(jpack.PackedLinear(
            packed=jpack.pack_indices(jnp.asarray(q_idx), 4, layout="pair"),
            scale=jnp.asarray(scale), lut=jnp.asarray(lut), bias=None,
            in_features=64, out_features=n, nbits=4,
            affine=jpack.affine_from_lut(lut), layout="pair"))
        parts_t.append(tpack.PackedLinear(
            packed=tpack.pack_indices(torch.from_numpy(q_idx), 4,
                                      layout="pair"),
            scale=t(scale), lut=t(lut), bias=None, in_features=64,
            out_features=n, nbits=4, affine=tpack.affine_from_lut(lut),
            layout="pair"))
    want = jpack.concat_packed(parts_j)
    got = tpack.concat_packed(parts_t)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.out_features == want.out_features == 64
