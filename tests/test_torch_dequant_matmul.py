"""Kernels K1 (pair), K2 (int8), K6 (pair3x), K7 (pair3), K8 (plane
table) and K9 (plane affine) of the port: their plain versions, which the
wrappers take for CPU tensors, against the JAX Pallas kernels in interpret
mode; the reference path against ``dequant_matmul_xla`` (mirrors
tests/test_fusion.py:52,67,98 and tests/test_ops.py:119,130,163,234,315,
459,522)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.codebooks import Codebook as JCodebook
from sleekit_tpu.ops import dequant_matmul as jdm
from sleekit_tpu.ops import pack as jpack
from sleekit_tpu_torch.ops import dequant_matmul as tdm
from sleekit_tpu_torch.ops import pack as tpack

from tests._torch_port_util import bf16_close, f32, t


def _pair(rng, nbits, K, N, bias=True, layout="pair"):
    lut = np.linspace(-1.0, 0.95, 2 ** nbits).astype(np.float32)
    idx = rng.randint(0, 2 ** nbits, (K, N))
    scale = rng.rand(N).astype(np.float32) + 0.5
    b = rng.randn(N).astype(np.float32) if bias else None
    jw = jpack.PackedLinear(
        packed=jpack.pack_indices(jnp.asarray(idx), nbits, layout=layout),
        scale=jnp.asarray(scale), lut=jnp.asarray(lut),
        bias=None if b is None else jnp.asarray(b), in_features=K,
        out_features=N, nbits=nbits, affine=jpack.affine_from_lut(lut),
        layout=layout)
    tw = tpack.PackedLinear(
        packed=t(np.asarray(jw.packed)), scale=t(scale), lut=t(lut),
        bias=None if b is None else t(b), in_features=K, out_features=N,
        nbits=nbits, affine=tpack.affine_from_lut(lut), layout=layout)
    return jw, tw


def _glue_args(rng, pre, use_res, K, M, N, bf16_ln=False):
    ln_s = ln_b = res = None
    if pre in ("layernorm", "rmsnorm"):
        ln_s = rng.rand(K).astype(np.float32) + 0.5
    if pre == "layernorm":
        ln_b = (0.1 * rng.randn(K)).astype(np.float32)
    if use_res:
        res = np.asarray(jnp.asarray(rng.randn(M, N).astype(np.float32)
                                     ).astype(jnp.bfloat16))
    jkw = dict(pre=pre, residual=None if res is None else jnp.asarray(res))
    tkw = dict(pre=pre, residual=None if res is None else t(res))
    for name, v in (("ln_scale", ln_s), ("ln_bias", ln_b)):
        jv = None if v is None else jnp.asarray(v)
        if bf16_ln and jv is not None:
            jv = jv.astype(jnp.bfloat16)
        jkw[name] = jv
        tkw[name] = None if jv is None else t(np.asarray(jv))
    return jkw, tkw


@pytest.mark.parametrize("nbits", [3, 4])
@pytest.mark.parametrize("pre,use_res,bias", [
    (None, False, False), (None, True, True), ("layernorm", False, True),
    ("layernorm", True, False), ("rmsnorm", False, True), ("relu", True, True),
    ("gelu", False, True), ("silu_glu", True, False)])
def test_pair_kernel_plain_matches_jax_kernel(nbits, pre, use_res, bias):
    """K1's plain version == the Pallas pair kernel (interpret), for every
    prologue, with and without residual and bias, at a K (400) that is not
    a multiple of the pair tile (masked norm statistics)."""
    rng = np.random.RandomState(11 + nbits)
    K, N, M = 400, 192, 5
    jw, tw = _pair(rng, nbits, K, N, bias=bias)
    xk = 2 * K if pre == "silu_glu" else K
    x = np.asarray(jnp.asarray(rng.randn(M, xk).astype(np.float32) * 2.0
                               ).astype(jnp.bfloat16))
    jkw, tkw = _glue_args(rng, pre, use_res, K, M, N)
    want = jdm.fused_quantized_matmul(jnp.asarray(x), jw, interpret=True,
                                      **jkw)
    got = tdm.fused_quantized_matmul(t(x), tw, use_kernel=True, **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    bf16_close(got, want, f"{nbits} {pre} {use_res}")


@pytest.mark.parametrize("pre,use_res", [
    (None, False), ("layernorm", True), ("rmsnorm", False)])
def test_int8_kernel_plain_matches_jax_kernel(pre, use_res):
    """K2's plain version == the Pallas int8 kernel (interpret) on a head
    whose vocab pads at pack time (N 300 -> 1024), incl. the slice to the
    true output width and bf16 norm parameters."""
    rng = np.random.RandomState(21)
    K, N, M = 200, 300, 4
    jw, tw = _pair(rng, 8, K, N, layout="int8")
    assert tuple(tw.packed.shape) == (224, 1024)
    x = np.asarray(jnp.asarray(rng.randn(M, K).astype(np.float32)
                               ).astype(jnp.bfloat16))
    jkw, tkw = _glue_args(rng, pre, use_res, K, M, N, bf16_ln=True)
    want = jdm.fused_quantized_matmul(jnp.asarray(x), jw, interpret=True,
                                      **jkw)
    got = tdm.fused_quantized_matmul(t(x), tw, use_kernel=True, **tkw)
    assert got.shape == (M, N)
    bf16_close(got, want, f"int8 {pre} {use_res}")


def test_quantized_matmul_kernel_dispatch_matches_jax():
    """quantized_matmul's kernel route (no prologue) == the JAX pallas
    dispatch for pair and int8 weights."""
    rng = np.random.RandomState(4)
    for nbits, layout in ((4, "pair"), (8, "int8")):
        jw, tw = _pair(rng, nbits, 256, 200, layout=layout)
        x = np.asarray(jnp.asarray(rng.randn(3, 256).astype(np.float32)
                                   ).astype(jnp.bfloat16))
        want = jdm.dequant_matmul_pallas(jnp.asarray(x), jw, interpret=True)
        got = tdm.quantized_matmul(t(x), tw, use_kernel=True)
        bf16_close(got[:, :200], np.asarray(want, np.float32)[:, :200],
                   layout)


@pytest.mark.parametrize("layout,nbits", [("pair", 4), ("pair", 2),
                                          ("int8", 8), ("linear", 4)])
def test_f32_reference_matches_xla(layout, nbits):
    """f32 activations take the reference path (the JAX package sends f32
    to XLA): equal to dequant_matmul_xla within 1e-5 (f32 sums in another
    order)."""
    rng = np.random.RandomState(9)
    jw, tw = _pair(rng, nbits, 160, 96, layout=layout)
    x = rng.randn(3, 160).astype(np.float32)
    want = np.asarray(jdm.dequant_matmul_xla(jnp.asarray(x), jw))
    for use_kernel in (False, True):
        got = tdm.quantized_matmul(t(x), tw, use_kernel=use_kernel)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(f32(got)[:, :96], want[:, :96],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pre", [None, "layernorm", "rmsnorm", "relu", "gelu",
                                 "silu_glu"])
def test_composed_reference_matches_jax(pre):
    """The composed (non-kernel) fused_quantized_matmul == JAX's, f32."""
    rng = np.random.RandomState(31)
    K, N, M = 128, 64, 3
    jw, tw = _pair(rng, 4, K, N)
    x = rng.randn(M, 2 * K if pre == "silu_glu" else K).astype(np.float32)
    jkw, tkw = _glue_args(rng, pre, False, K, M, N)
    res = rng.randn(M, N).astype(np.float32)
    want = jdm.fused_quantized_matmul(jnp.asarray(x), jw, use_pallas=False,
                                      **{**jkw, "residual": jnp.asarray(res)})
    got = tdm.fused_quantized_matmul(t(x), tw, use_kernel=False,
                                     **{**tkw, "residual": t(res)})
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _pair3(rng, layout, K, N, bias):
    """A 3-bit uniform-codebook matrix in ``layout`` for both packages."""
    lut = np.linspace(-1.0, 1.0, 8).astype(np.float32)
    idx = rng.randint(0, 8, (K, N))
    scale = rng.rand(N).astype(np.float32) + 0.5
    b = rng.randn(N).astype(np.float32) if bias else None
    jw = jpack.PackedLinear(
        packed=jpack.pack_indices(jnp.asarray(idx), 3, layout=layout),
        scale=jnp.asarray(scale), lut=jnp.asarray(lut),
        bias=None if b is None else jnp.asarray(b), in_features=K,
        out_features=N, nbits=3, affine=jpack.affine_from_lut(lut),
        layout=layout)
    tw = tpack.PackedLinear(
        packed=t(np.asarray(jw.packed)), scale=t(scale), lut=t(lut),
        bias=None if b is None else t(b), in_features=K, out_features=N,
        nbits=3, affine=tpack.affine_from_lut(lut), layout=layout)
    return jw, tw


@pytest.mark.parametrize("layout,K,pre,use_res,bias", [
    ("pair3", 400, None, True, True),
    ("pair3", 400, "layernorm", False, True),
    ("pair3", 400, "gelu", False, False),
    ("pair3", 400, "silu_glu", True, True),
    ("pair3x", 512, None, False, True),
    ("pair3x", 512, "rmsnorm", True, False),
    ("pair3x", 512, "relu", True, True),
    ("pair3x", 512, "layernorm", True, True)])
def test_pair3_kernels_plain_match_jax_kernel(layout, K, pre, use_res, bias):
    """K7 ('pair3', K 400: not a multiple of its 256-row tile) and K6
    ('pair3x') plain versions == the Pallas pair kernel (interpret) with
    pair3=True / p3x=True: every prologue, each layout with and without
    residual and bias (mirrors tests/test_ops.py:315,459,522)."""
    rng = np.random.RandomState(K + len(str(pre)))
    N, M = 136, 5
    jw, tw = _pair3(rng, layout, K, N, bias)
    xk = 2 * K if pre == "silu_glu" else K
    x = np.asarray(jnp.asarray(rng.randn(M, xk).astype(np.float32) * 2.0
                               ).astype(jnp.bfloat16))
    jkw, tkw = _glue_args(rng, pre, use_res, K, M, N)
    want = jdm.fused_quantized_matmul(jnp.asarray(x), jw, interpret=True,
                                      **jkw)
    got = tdm.fused_quantized_matmul(t(x), tw, use_kernel=True, **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    bf16_close(got, want, f"{layout} {pre} {use_res}")


def _plane(rng, lut, K, N):
    lut = np.asarray(lut, np.float32)
    nbits = jpack.bits_for_codebook(lut.size)
    idx = rng.randint(0, lut.size, (K, N))
    scale = rng.rand(N).astype(np.float32) + 0.5
    b = rng.randn(N).astype(np.float32)
    jw = jpack.PackedLinear(
        packed=jpack.pack_indices(jnp.asarray(idx), nbits, layout="plane"),
        scale=jnp.asarray(scale), lut=jnp.asarray(lut), bias=jnp.asarray(b),
        in_features=K, out_features=N, nbits=nbits,
        affine=jpack.affine_from_lut(lut), layout="plane")
    tw = tpack.PackedLinear(
        packed=t(np.asarray(jw.packed)), scale=t(scale), lut=t(lut),
        bias=t(b), in_features=K, out_features=N, nbits=nbits,
        affine=tpack.affine_from_lut(lut), layout="plane")
    return jw, tw


PLANE_LUTS = {
    "nf4": np.asarray(JCodebook.nf4().values),
    "ternary": [-1.0, 0.0, 1.0],
    "table3": [-1.0, 0.1, 1.0],
    "table8": [0.3, -1.0, 0.7, 0.05, -0.4, 1.0, -0.1, 0.5],
    "affine8": np.linspace(-1.0, 1.0, 256),
    "uniform3": np.linspace(-1.0, 1.0, 8),
    "uniform4": np.linspace(-1.0, 1.0, 16),
}


@pytest.mark.parametrize("name", list(PLANE_LUTS))
def test_plane_kernels_plain_match_jax_kernel(name, monkeypatch):
    """K8 (NF4, a k = 3 table at 2 bits, an unsorted 8-entry table, the
    8-bit affine grid) and K9 (uniform 3 and 4 bits, and the ternary grid
    {-1, 0, 1}, affine at 2 bits) plain versions ==
    dequant_matmul_pallas (interpret) over 'plane' words, reached through
    quantized_matmul's dispatch, at a K (700) off every plane tile
    (mirrors tests/test_ops.py:119,130)."""
    rng = np.random.RandomState(len(name))
    jw, tw = _plane(rng, PLANE_LUTS[name], 700, 96)
    x = np.asarray(jnp.asarray(rng.randn(4, 700).astype(np.float32)
                                ).astype(jnp.bfloat16))
    want = jdm.dequant_matmul_pallas(jnp.asarray(x), jw, interpret=True)
    taken = []
    for fn in ("plane_lut_matmul_plain", "plane_affine_matmul_plain"):
        monkeypatch.setattr(tdm, fn, lambda *a, _o=getattr(tdm, fn), _n=fn,
                            **k: taken.append(_n) or _o(*a, **k))
    for use_kernel in (False, True):
        got = tdm.quantized_matmul(t(x), tw, use_kernel=use_kernel)
        assert got.dtype == torch.bfloat16
        bf16_close(got, want, name)
    kind = "lut" if tw.affine is None or tw.nbits == 8 else "affine"
    assert taken == [f"plane_{kind}_matmul_plain"] * 2


@pytest.mark.parametrize("name", ["nf4", "uniform4"])
def test_plane_f32_reference_matches_xla(name):
    """f32 activations on 'plane' take the reference path: equal to
    dequant_matmul_xla within 1e-5."""
    rng = np.random.RandomState(7)
    jw, tw = _plane(rng, PLANE_LUTS[name], 300, 40)
    x = rng.randn(3, 300).astype(np.float32)
    want = np.asarray(jdm.dequant_matmul_xla(jnp.asarray(x), jw))
    got = tdm.quantized_matmul(t(x), tw, use_kernel=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["pair3x", "plane"])
def test_tpu_schedules_change_nothing(layout, monkeypatch):
    """LUT_POLY and PAIR_TUNE['p3m'] are TPU schedules: every setting gives
    the port's same output."""
    rng = np.random.RandomState(2)
    _, tw = (_pair3(rng, layout, 512, 64, True) if layout == "pair3x"
             else _plane(rng, PLANE_LUTS["nf4"], 512, 64))
    x = t(np.asarray(jnp.asarray(rng.randn(3, 512).astype(np.float32)
                                 ).astype(jnp.bfloat16)))
    base = tdm.quantized_matmul(x, tw, use_kernel=True)
    for poly in (False, True):
        for p3m in (0, 1, 2):
            monkeypatch.setattr(tdm, "LUT_POLY", poly)
            monkeypatch.setitem(tdm.PAIR_TUNE, "p3m", p3m)
            assert torch.equal(tdm.quantized_matmul(x, tw, use_kernel=True),
                               base)
