"""The tensor-parallel row-sharding format of the packed weights in the
port against the JAX package's (mirrors tests/test_tp_packed.py:39,52):
``split_packed_k`` words bit for bit over the six layouts, ``dequantize``
of a split matrix, and the sum of the ranks' matmuls over their localized
shards equal to the full matrix's."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.ops import pack as jpack
from sleekit_tpu.ops.dequant_matmul import (
    dequant_matmul_pallas, dequant_matmul_xla)
from sleekit_tpu_torch.ops import pack as tpack
from sleekit_tpu_torch.ops.dequant_matmul import quantized_matmul
from sleekit_tpu_torch.parallel.mesh import Mesh, _shard_linear

from tests._torch_port_util import f32, t

# (layout, nbits, K, n): widths on and off their layout's tile, in 2 and 4
# shards; 'pair3x' keeps its layout in shards of 512 rows and re-packs as
# 'pair3' in shards of 256.
SPLITS = [("pair", 2, 256, 2), ("pair", 3, 480, 4), ("pair", 4, 1024, 2),
          ("pair", 4, 1024, 4), ("pair", 7, 300, 2), ("pair3", 3, 768, 2),
          ("pair3", 3, 768, 4), ("pair3x", 3, 1024, 2),
          ("pair3x", 3, 512, 2), ("pair3x", 3, 2048, 4),
          ("plane", 1, 1024, 4), ("plane", 3, 640, 2), ("plane", 4, 200, 2),
          ("plane", 8, 256, 4), ("int8", 8, 200, 2), ("int8", 8, 256, 4),
          ("linear", 4, 160, 4), ("linear", 3, 120, 2)]


# The JAX side compiled once a case: its ops one by one take seconds.
_j_pack = jax.jit(jpack.pack_indices, static_argnums=1,
                  static_argnames="layout")


def _j_split(jp, n):
    """JAX's ``split_packed_k(jp, n)`` and its dequantized matrix."""
    split = jax.jit(lambda packed: jpack.split_packed_k(
        dataclasses.replace(jp, packed=packed), n))(jp.packed)
    return split, jax.jit(lambda w: w.dequantize())(split)


def _linear(layout, nbits, k, n, seed):
    """The same random linear in both packages: (JAX, port)."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, 2 ** nbits, (k, n))
    packed = np.asarray(_j_pack(jnp.asarray(idx), nbits, layout=layout))
    out_f = packed.shape[1]     # the int8 layout pads N
    lut = np.linspace(-1, 1, 2 ** nbits, dtype=np.float32)
    scale = (0.02 * (1 + 0.1 * rng.rand(out_f))).astype(np.float32)
    bias = (0.01 * rng.randn(out_f)).astype(np.float32)
    fields = dict(in_features=k, out_features=out_f, nbits=nbits,
                  affine=jpack.affine_from_lut(jnp.asarray(lut)),
                  layout=layout)
    jp = jpack.PackedLinear(packed=jnp.asarray(packed),
                            scale=jnp.asarray(scale), lut=jnp.asarray(lut),
                            bias=jnp.asarray(bias), **fields)
    tp = tpack.PackedLinear(packed=t(packed), scale=t(scale), lut=t(lut),
                            bias=t(bias), **fields)
    return jp, tp


@pytest.mark.parametrize("layout,nbits,k,n", SPLITS)
def test_split_packed_k_words_and_dequantize_match_jax(layout, nbits, k, n):
    """The split words, layout and k_splits are the JAX package's, bit for
    bit; ``dequantize`` of the split matrix is JAX's and the unsplit
    matrix's."""
    jp, tp = _linear(layout, nbits, k, 48, seed=nbits * 31 + k)
    want, want_deq = _j_split(jp, n)
    got = tpack.split_packed_k(tp, n)
    assert (got.layout, got.k_splits) == (want.layout, n)
    assert got.packed.dtype == {"int8": torch.int8}.get(layout, torch.int32)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    deq = got.dequantize().numpy()
    np.testing.assert_array_equal(deq, np.asarray(want_deq))
    np.testing.assert_array_equal(deq, tp.dequantize().numpy())


def test_split_packed_k_refuses_what_jax_refuses():
    """An uneven K and a matrix split twice raise; a matmul over a split
    matrix raises, naming localize_packed_shard, as JAX's asserts do."""
    _, tp = _linear("pair", 4, 256, 16, seed=0)
    with pytest.raises(ValueError, match="not divisible"):
        tpack.split_packed_k(tp, 3)
    split = tpack.split_packed_k(tp, 2)
    with pytest.raises(ValueError, match="already split"):
        tpack.split_packed_k(split, 2)
    with pytest.raises(ValueError, match="localize_packed_shard"):
        quantized_matmul(torch.zeros(2, 256, dtype=torch.bfloat16), split)
    with pytest.raises(ValueError, match="split_packed_k\\(2\\) first"):
        tpack.localize_packed_shard(tp, 2, row_parallel=True)


# (layout, nbits, K, n): the row-parallel layouts the kernels take.
ROW_SHARDS = [("pair", 4, 512, 4), ("pair", 3, 512, 4), ("plane", 4, 512, 4),
              ("plane", 3, 512, 4), ("pair3", 3, 1024, 2),
              ("pair3x", 3, 2048, 2), ("pair3x", 3, 1024, 2)]


@pytest.mark.parametrize("layout,nbits,k,n", ROW_SHARDS)
def test_row_shards_sum_to_the_full_matmul(layout, nbits, k, n):
    """Each rank's plain kernel version (K1, K6, K7 or K9 at bf16 x) over
    its localized (K/n, N) shard of the split matrix, summed over the
    ranks: JAX's full-matrix XLA oracle and its kernel in interpret mode
    within JAX's tolerance (2e-2), the bias added once after the sum."""
    jp, tp = _linear(layout, nbits, k, 256, seed=k + n)
    x = np.random.RandomState(2).randn(8, k).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    split = tpack.split_packed_k(dataclasses.replace(tp, bias=None), n)
    got = 0
    for r in range(n):
        mesh = Mesh(rank=r, model=n, device=torch.device("cpu"))
        local = _shard_linear("o", split, mesh, mesh.device)
        assert (local.in_features, local.k_splits) == (k // n, 1)
        xs = t(xb)[:, r * k // n:(r + 1) * k // n]
        got = got + quantized_matmul(xs, local).float()
    got = f32(got + tp.bias)
    want_xla = np.asarray(jax.jit(dequant_matmul_xla)(jnp.asarray(x), jp))
    np.testing.assert_allclose(got, want_xla, rtol=2e-2, atol=3e-2)
    if layout in ("pair", "plane"):
        want = np.asarray(jax.jit(lambda x, w: dequant_matmul_pallas(
            x, w, interpret=True))(xb, jp), np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("layout,row", [("pair", False), ("int8", False),
                                        ("pair", True), ("plane", True)])
def test_shard_linear_cuts_what_jax_shards(layout, row):
    """One rank's block of a linear: column-parallel, the packed words,
    scale and bias on N (the int8 head over its padded width);
    row-parallel, the split word rows with the scale and bias replicated.
    The blocks concatenate back to the JAX package's arrays."""
    nbits = 8 if layout == "int8" else 4
    jp, tp = _linear(layout, nbits, 256, 2048 if layout == "int8" else 64,
                     seed=5)
    if row:
        jp, tp = _j_split(jp, 2)[0], tpack.split_packed_k(tp, 2)
    blocks = [_shard_linear("o" if row else "q", tp,
                            Mesh(rank=r, model=2, device=torch.device("cpu")),
                            torch.device("cpu")) for r in range(2)]
    axis = 0 if row else 1
    np.testing.assert_array_equal(
        torch.cat([b.packed for b in blocks], dim=axis).numpy(),
        np.asarray(jp.packed))
    for b in blocks:
        if row:
            assert (b.in_features, b.out_features) == (128, jp.out_features)
            np.testing.assert_array_equal(b.scale.numpy(),
                                          np.asarray(jp.scale))
        else:
            assert (b.in_features, b.out_features) == (256,
                                                       jp.out_features // 2)
    if not row:
        np.testing.assert_array_equal(
            torch.cat([b.bias for b in blocks]).numpy(), np.asarray(jp.bias))
