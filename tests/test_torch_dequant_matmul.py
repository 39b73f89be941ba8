"""Kernels K1 (pair), K2 (int8), K6 (pair3x), K7 (pair3), K8 (plane
table) and K9 (plane affine) of the port: their plain versions, which the
wrappers take for CPU tensors, against the JAX Pallas kernels in interpret
mode; the reference path against ``dequant_matmul_xla`` (mirrors
tests/test_fusion.py:52,67,98 and tests/test_ops.py:119,130,163,234,315,
459,522)."""

from pathlib import Path

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


@pytest.mark.parametrize("M", [4, 20])
@pytest.mark.parametrize("pre,use_res", [
    (None, False), ("layernorm", True), ("rmsnorm", False)])
def test_int8_kernel_plain_matches_jax_kernel(pre, use_res, M):
    """K2's plain version == the Pallas int8 kernel (interpret) on a head
    whose vocab pads at pack time (N 300 -> 1024), incl. the slice to the
    true output width and bf16 norm parameters, at a decode M (4) and a
    prefill M (20, the kernel's tensor-core route on the card)."""
    rng = np.random.RandomState(21)
    K, N = 200, 300
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
def test_plane_f32_reference_matches_xla(name, monkeypatch):
    """f32 activations on 'plane' take K8f's (NF4) or K9f's (uniform
    int4) plain version, not the reference path (the JAX package sends
    'plane' to its Pallas kernel at f32 as well): equal to
    dequant_matmul_xla within 1e-5."""
    rng = np.random.RandomState(7)
    jw, tw = _plane(rng, PLANE_LUTS[name], 300, 40)
    x = rng.randn(3, 300).astype(np.float32)
    want = np.asarray(jdm.dequant_matmul_xla(jnp.asarray(x), jw))
    taken = []
    for fn in ("plane_lut_matmul_plain", "plane_affine_matmul_plain",
               "dequant_matmul_ref"):
        monkeypatch.setattr(tdm, fn, lambda *a, _o=getattr(tdm, fn), _n=fn,
                            **k: taken.append(_n) or _o(*a, **k))
    got = tdm.quantized_matmul(t(x), tw, use_kernel=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), want, rtol=1e-5, atol=1e-5)
    assert taken == ["plane_lut_matmul_plain" if name == "nf4"
                     else "plane_affine_matmul_plain"]


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


@pytest.mark.parametrize("layout,K,pre", [
    ("pair", 256, None), ("pair", 256, "layernorm"),
    ("pair3", 400, None), ("pair3", 400, "relu"),
    ("pair3x", 512, None), ("pair3x", 512, "silu_glu")])
def test_prefill_m_plain_matches_jax_kernel(layout, K, pre):
    """At prefill M (520 rows, above JAX's PREFILL_CHUNK_M = 512), K1's
    and K6/K7's plain versions, which their wrappers take for CPU tensors,
    == the Pallas pair kernel (interpret): without a prologue through
    dequant_matmul_pallas, which chunks M at 512 rows; with one (and a
    residual) through fused_quantized_matmul."""
    assert 520 > jdm.PREFILL_CHUNK_M
    rng = np.random.RandomState(K + len(layout))
    M, N = 520, 64
    jw, tw = (_pair(rng, 4, K, N) if layout == "pair"
              else _pair3(rng, layout, K, N, True))
    xk = 2 * K if pre == "silu_glu" else K
    x = np.asarray(jnp.asarray(rng.randn(M, xk).astype(np.float32)
                               ).astype(jnp.bfloat16))
    if pre is None:
        want = jdm.dequant_matmul_pallas(jnp.asarray(x), jw, interpret=True)
        got = tdm.quantized_matmul(t(x), tw, use_kernel=True)
    else:
        jkw, tkw = _glue_args(rng, pre, True, K, M, N)
        want = jdm.fused_quantized_matmul(jnp.asarray(x), jw,
                                          interpret=True, **jkw)
        got = tdm.fused_quantized_matmul(t(x), tw, use_kernel=True, **tkw)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    bf16_close(got, np.asarray(want, np.float32)[:, :N],
               f"{layout} {pre} M={M}")


@pytest.mark.parametrize("m,k,cols", [
    (1, 2048, 2048),    # decode: K2's streaming route reads it too
    (8, 200, 256),      # K rounded up to XP_CHUNK
    (9, 64, 64),
    (64, 4096, 4096),
    (520, 100, 128),
    (1, 400, 448),      # on both sides of DECODE_M
    (8, 400, 448),
    (9, 400, 448),
    (520, 400, 448),
])
def test_xp_scratch_at_every_m(m, k, cols):
    """The wrappers of K1, K2 and K6-K9 allocate the prologue pass's
    scratch at every M, in one buffer: pre(x) in bf16 with K rounded up to
    XP_CHUNK columns at its start, then one f32 row sum a row, 16-byte
    aligned; K1 and K6-K9 at M <= DECODE_M over more than one K split put
    their f32 partials and one int32 ticket a 32-column strip after it
    ('pair' and 'plane' int4 words of a 2048 x 2048 matrix)."""
    got, splits, rs, part, tickets, size = tdm._scratch_layout(m, k)
    assert (got, splits, rs, part, tickets) == (cols, 1, m * cols * 2, 0, 0)
    assert rs % 16 == 0 and size >= rs + 4 * m
    n, kw = 2048, 256       # int4 words of a 2048 x 2048 matrix
    for layout in ("pair", "plane"):
        strips, want = tdm.stream_plan(n, kw, layout, nbits=4)
        got, splits, rs, part, tickets, size = tdm._scratch_layout(
            m, k, n, kw, layout, nbits=4)
        assert (got, rs) == (cols, m * cols * 2)
        if m <= tdm.DECODE_M:
            assert splits == want > 1 and part % 16 == 0
            assert part >= rs + 4 * m
            assert tickets == part + 4 * splits * m * n
            assert size == tickets + 4 * strips
        else:
            assert (splits, part, tickets) == (1, 0, 0)


def _plane_rule(nbits):
    """(fields a word, K rows a tile, fields a decode unit, units a 16 word
    rows, 64-row chunks a tile) of the 'plane' tile rule
    (``csrc/plane_matmul.cu`` ``Plane``)."""
    vpw = tpack.vals_per_word(nbits)
    steps = tdm.plane_unit_steps(nbits)
    return vpw, 32 * vpw, steps, vpw // steps, vpw // 2


def _plane_step(u, s, t4, nbits):
    """(first K row, the lane's word rows, field) of step s of the 'plane'
    streaming kernel's unit u for lane t4 (``Plane::step_row``,
    ``unit_rows`` and ``stream_unit``)."""
    _, bk, steps, sub, _ = _plane_rule(nbits)
    q = u // sub
    k0 = q // 2 * bk + 16 * (q % 2) + 32 * (u % sub * steps + s)
    return k0, [q * 16 + 4 * t4 + i for i in range(4)], u % sub * steps + s


def _layout_bits(layout):
    """('plane', 3) for 'plane3'; (layout, 4) for the others."""
    if layout.startswith("plane"):
        return "plane", int(layout[5:])
    return layout, 4


def _kw(K, layout):
    """Word rows of K rows of 4-bit 'pair', 'pair3' or 'pair3x' words, or
    of 'plane<nbits>' words."""
    if layout.startswith("plane"):
        bk = _plane_rule(_layout_bits(layout)[1])[1]
        return -(-K // bk) * 32
    if layout == "pair":
        pg = tpack.pair_group(4)
        return -(-K // (2 * pg * tpack.pair_planes(4))) * pg
    if layout == "pair3":
        return -(-K // tpack.PAIR3_TILE) * tpack.PAIR3_WORDS
    return K // tpack.PAIR3X_GROUP * tpack.PAIR3X_WORDS


def _unit_steps(u, layout):
    """First K rows of the k16 steps of unit u, as the streaming kernel's
    ``step_row`` walks them (4-bit 'pair': tiles of 256 rows, 32 word
    rows; 8 word rows a unit, one step in each of 4 planes)."""
    if layout.startswith("plane"):
        nbits = _layout_bits(layout)[1]
        return [_plane_step(u, s, 0, nbits)[0]
                for s in range(_plane_rule(nbits)[2])]
    if layout == "pair":
        w = 8 * u
        return [w // 32 * 256 + 2 * (w % 32) + 64 * j for j in range(4)]
    if layout == "pair3":
        return [u // 2 * 256 + 16 * (2 * q + u % 2) for q in range(8)]
    g, r = divmod(u, 6)
    if r < 4:
        return [g * 512 + 64 * j + 16 * r for j in range(4)]
    return [g * 512 + 256 + 16 * (2 * q + r - 4) for q in range(8)]


_PLAN_SHAPES = [
    (2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),  # OPT-1.3B
    (4096, 6144), (14336, 4096),    # llama3-8b: fused qkv, down
    (2048, 198),                    # ragged N
    (400, 2048),                    # K below one tile (not pair3x's K)
]


@pytest.mark.parametrize("layout,K,N", [
    (layout, K, N) for layout in ("pair", "pair3", "pair3x", "plane4",
                                  "plane3")
    for K, N in _PLAN_SHAPES if layout != "pair3x" or K % 512 == 0])
def test_stream_plan_fills_the_card(layout, K, N):
    """The streaming kernel of K1, K6, K7 and K8/K9 ('plane' at 4 and 3
    bits) at decode M: its strips of STREAM_COLS columns (the source's
    PAIR_COLS, in blocks of STREAM_WARPS warps) and K splits fill at least
    the H100's 132 SMs with blocks, or split as far as K allows (one split
    where K is below a warp's unit in each split); the splits cut the
    units without gap or overlap, and the units' k16 steps below K tile K
    exactly, once each."""
    src = (Path(tdm.__file__).parent.parent / "csrc"
           / "dequant_routes.cuh").read_text()
    assert f"constexpr int PAIR_COLS = {tdm.STREAM_COLS};" in src
    assert "constexpr int THREADS = 256;" in src and tdm.STREAM_WARPS == 8
    kw = _kw(K, layout)
    name, nbits = _layout_bits(layout)
    units = tdm.stream_units(kw, name, nbits)
    strips, splits = tdm.stream_plan(N, kw, name, nbits=nbits)
    most = max(1, units // tdm.STREAM_WARPS)
    assert strips == -(-N // tdm.STREAM_COLS)
    assert 1 <= splits <= most
    assert strips * splits >= tdm.H100_SMS or splits == most
    if K == 400:
        assert splits == 1
    cuts = [(units * s // splits, units * (s + 1) // splits)
            for s in range(splits)]    # the kernel's cut of the units
    assert cuts[0][0] == 0 and cuts[-1][1] == units
    assert all(a < b for a, b in cuts)
    assert all(cuts[i][1] == cuts[i + 1][0] for i in range(splits - 1))
    rows = sorted(r for u in range(units) for r in _unit_steps(u, layout)
                  if r < K)
    assert rows == list(range(0, K, 16))


@pytest.mark.parametrize("nbits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("K", [700, 2048])
def test_plane_routes_read_every_k_row_once(nbits, K):
    """The 'plane' tile rule of K8/K9 (a Python mirror of
    ``csrc/plane_matmul.cu`` ``Plane``) against the packer's words: on the
    streaming route, lane t4's word rows and field of each step hold the
    indices of its K rows 4*t4 .. 4*t4 + 3 of the step; on the tensor-core
    route, B register h of lane t4 at step s of chunk c holds K rows 64c +
    16s + 8h + 2*t4 and + 1 in field 2(c % CPT) + s/2 of the chunk's word
    rows (s%2)*16 + 8h + 2*t4 and + 1; each route reads every K row below
    K exactly once (at 3 bits, K = 2048 ends inside the last 320-row
    tile; K = 700 inside a tile at every width), and the streaming route's
    rows grow with the step, so it may stop at the first step past K."""
    vpw, bk, steps, sub, cpt = _plane_rule(nbits)
    rng = np.random.RandomState(K + nbits)
    idx = rng.randint(0, 2 ** nbits, (K, 4))
    words = tpack.pack_indices(torch.as_tensor(idx), nbits,
                               layout="plane").long() & 0xFFFFFFFF
    kw = words.shape[0]
    assert kw == _kw(K, f"plane{nbits}")

    def field(r, j):
        return (words[r] >> (nbits * j)) & (2 ** nbits - 1)

    seen = []
    for u in range(tdm.stream_units(kw, "plane", nbits)):
        firsts = [_plane_step(u, s, 0, nbits)[0] for s in range(steps)]
        assert firsts == sorted(firsts)
        for s in range(steps):
            for t4 in range(4):
                k0, rows, j = _plane_step(u, s, t4, nbits)
                if k0 >= K:
                    continue
                for i, r in enumerate(rows):
                    k = k0 + 4 * t4 + i
                    if k < K:
                        assert torch.equal(field(r, j),
                                           torch.as_tensor(idx[k])), (u, s)
                        seen.append(k)
    assert sorted(seen) == list(range(K))
    seen = []
    for c in range(-(-K // tdm.XP_CHUNK)):   # the chunks of xp_cols(K)
        first = c // cpt * 32                # chunk_words
        for s in range(4):
            for h in range(2):
                for t4 in range(4):
                    for e in range(2):
                        k = 64 * c + 16 * s + 8 * h + 2 * t4 + e
                        r = first + (s % 2) * 16 + 8 * h + 2 * t4 + e
                        if k < K:
                            assert torch.equal(
                                field(r, 2 * (c % cpt) + s // 2),
                                torch.as_tensor(idx[k])), (c, s)
                            seen.append(k)
    assert sorted(seen) == list(range(K))
