"""The packed format is a shared contract: the port's words are
bit-identical to the JAX package's (mirrors tests/test_ops.py:26,152,234,
273,285,445)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.codebooks import UniformCodebook as JUniform
from sleekit_tpu.ops import pack as jpack
from sleekit_tpu.scaling import compute_non_saturating_scaling as j_nonsat
from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook
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


@pytest.mark.parametrize("layout,nbits,ks", [
    ("plane", 1, (77, 1024, 1100)), ("plane", 2, (77, 512, 600)),
    ("plane", 3, (77, 320, 700)), ("plane", 4, (77, 256, 300)),
    ("plane", 8, (77, 128, 200)), ("pair3", 3, (256, 300, 768)),
    ("pair3x", 3, (512, 1536))])
def test_plane_pair3_pair3x_words_bit_identical(layout, nbits, ks):
    """'plane' at 1-8 bits (10 fields a word at 3 bits), 'pair3' and
    'pair3x': the JAX package's words, at K on and off the tile; unpack
    inverts them."""
    rng = np.random.RandomState(nbits + len(layout))
    for k in ks:
        idx = rng.randint(0, 2 ** nbits, (k, 37))
        want = np.asarray(jpack.pack_indices(jnp.asarray(idx), nbits,
                                             layout=layout))
        got = tpack.pack_indices(torch.from_numpy(idx), nbits, layout=layout)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        back = tpack.unpack_indices(got, nbits, k, layout=layout)
        np.testing.assert_array_equal(back.numpy(), idx)


@pytest.mark.parametrize("layout", ["plane", "pair3", "pair3x"])
def test_unported_layouts_name_their_roadmap_item(layout):
    """The three layouts pack now; what stays unported around them, the
    tensor-parallel row-shard format (k_splits > 1), names its ROADMAP
    item. pair3x refuses K % 512 != 0 and names pair3; the 3-bit layouts
    refuse other widths."""
    w = tpack.PackedLinear(
        packed=tpack.pack_indices(torch.zeros((512, 8), dtype=torch.int64),
                                  3, layout=layout),
        scale=torch.ones(8), lut=torch.linspace(-1, 1, 8), bias=None,
        in_features=512, out_features=8, nbits=3, layout=layout, k_splits=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        w.dequantize()
    if layout == "pair3x":
        with pytest.raises(ValueError, match="pair3'"):
            tpack.pack_indices(torch.zeros((768, 8), dtype=torch.int64), 3,
                               layout=layout)
    elif layout == "pair3":
        with pytest.raises(ValueError, match="3-bit"):
            tpack.pack_indices(torch.zeros((256, 8), dtype=torch.int64), 4,
                               layout=layout)


@pytest.mark.parametrize("codebook,in_f,layout", [
    ("uniform3", 1024, "pair3x"), ("uniform3", 768, "pair3"),
    ("nf4", 96, "plane"), ("table3", 300, "plane")])
def test_pack_quantized_auto_layouts_match_jax(codebook, in_f, layout):
    """pack_quantized's 'auto' choice at 3 bits (pair3x when K % 512 == 0,
    else pair3) and for table codebooks (plane): JAX's layout, words,
    metadata, dequantized matrix and memory_bytes; pair3x stores 0.875x
    the int4 pair bytes."""
    rng = np.random.RandomState(len(codebook) + in_f)
    jcb, cb = {"uniform3": (JUniform(8, -1.0, 1.0),
                            UniformCodebook(8, -1.0, 1.0)),
               "nf4": (JCodebook.nf4(), Codebook.nf4()),
               "table3": (JCodebook.create([-1.0, 0.2, 1.0]),
                          Codebook.create([-1.0, 0.2, 1.0]))}[codebook]
    w = rng.randn(16, in_f).astype(np.float32)
    scale = (0.5 + rng.rand(16)).astype(np.float32)
    q = np.asarray(jcb(jnp.asarray(w / scale[:, None]))) * scale[:, None]
    want = jpack.pack_quantized(jnp.asarray(q), jnp.asarray(scale), jcb)
    got = tpack.pack_quantized(t(q), t(scale), cb)
    assert got.layout == want.layout == layout
    assert (got.nbits, got.affine, got.vpw) == (want.nbits, want.affine,
                                                want.vpw)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))
    assert got.memory_bytes() == want.memory_bytes()
    if layout == "pair3x":
        p4 = tpack.pack_indices(torch.zeros((in_f, 16), dtype=torch.int64),
                                4, layout="pair")
        assert got.packed.numel() == 0.875 * p4.numel()


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
