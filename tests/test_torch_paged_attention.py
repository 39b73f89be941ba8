"""Kernels K5 (fused append + flash decode over the page pool), K14 (paged
append) and K15 (paged flash decode) of the port: their plain versions,
which the wrappers take for CPU tensors, against the JAX Pallas kernels in
interpret mode, and the paged route against the slot route over the same
rows (mirrors tests/test_paged_attention.py:40,62,83,121,155,181,217)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.ops import attention as jattn
from sleekit_tpu.ops import paged_attention as jpaged
from sleekit_tpu_torch.ops import attention as tattn
from sleekit_tpu_torch.ops import paged_attention as tpaged

from tests._torch_port_util import bf16_close, f32, t

PS, MAXP = 16, 3


def _setup(cache="f32", B=3, G=2, L=2, KV=2, D=64, seed=0, P=None):
    """A pool (L, P, KV, PS, D) of ``cache`` kind ("f32", "bf16", "int8"
    with bf16 scales or "int8-f32" with f32 scales), a table of distinct
    pages in random order (page 0 unused), and new K/V and q in the
    compute dtype (bf16 for a bf16 pool, else f32)."""
    rng = np.random.RandomState(seed)
    P = P or B * MAXP + 2
    shape = (L, P, KV, PS, D)
    jdt = jnp.bfloat16 if cache == "bf16" else jnp.float32
    if cache.startswith("int8"):
        sdt = jnp.float32 if cache == "int8-f32" else jnp.bfloat16
        pk, ks = jattn._quant_rows(jnp.asarray(rng.randn(*shape), jnp.float32))
        pv, vs = jattn._quant_rows(jnp.asarray(rng.randn(*shape), jnp.float32))
        pools = [np.asarray(pk), np.asarray(pv),
                 np.asarray(ks[..., 0].astype(sdt)),
                 np.asarray(vs[..., 0].astype(sdt))]
    else:
        pools = [np.asarray(jnp.asarray(rng.randn(*shape), jdt))
                 for _ in range(2)] + [None, None]
    table = (1 + rng.permutation(P - 1)[:B * MAXP]).reshape(B, MAXP)
    table = table.astype(np.int32)
    kn, vn = (np.asarray(jnp.asarray(rng.randn(B, KV, D), jdt))
              for _ in range(2))
    q = np.asarray(jnp.asarray(rng.randn(B, KV * G, D), jdt))
    return pools, table, kn, vn, q


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else t(a)


def _slopes(H, alibi):
    return np.linspace(0.05, 0.7, H).astype(np.float32) if alibi else None


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "int8-f32"])
@pytest.mark.parametrize("pos_kind", ["scalar", "ragged"])
def test_paged_kv_append_plain_matches_jax_kernel(cache, pos_kind):
    """K14's plain version (the wrapper on CPU tensors) writes the bytes of
    paged_kv_append_pallas (interpret) into every plane, positions at page
    boundaries and beyond the last page (clamped to MAXP*PS - 1); with f32
    scale planes, those of the XLA oracle, run op by op (jitted, XLA turns
    the kernel's max|x| / 127 into a product with 1/127: ROADMAP queue
    3)."""
    pools, table, kn, vn, _ = _setup(cache, B=4, seed=1)
    pos = (np.int32(PS + 3) if pos_kind == "scalar"
           else np.asarray([0, PS - 1, PS, MAXP * PS + 4], np.int32))
    jargs = (_j(kn), _j(vn), _j(pools[0]), _j(pools[1]), _j(table),
             _j(pos), jnp.int32(1))
    jsc = dict(k_scale=_j(pools[2]), v_scale=_j(pools[3]))
    if cache == "int8-f32":
        want = jpaged.paged_kv_append_xla(*jargs, **jsc)
    else:
        want = jpaged.paged_kv_append_pallas(*jargs, **jsc, interpret=True)
    tp = [_t(a) for a in pools]
    got = tpaged.paged_kv_append(
        t(kn), t(vn), tp[0], tp[1], t(table),
        int(pos) if pos_kind == "scalar" else t(pos), 1, tp[2], tp[3])
    assert len(got) == len(want) and got[0] is tp[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(f32(g), f32(w))


@pytest.mark.parametrize("dtype,G", [("f32", 1), ("f32", 4), ("bf16", 4)])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_flash_decode_plain_matches_jax_kernel(G, alibi, quant, dtype):
    """K15's plain version == paged_flash_decode_pallas (interpret) over
    the logical rows s <= pos, within 1e-5 in f32 and the bf16 tolerance
    (rtol 2^-6, atol 1e-2*max|ref|) in bf16."""
    cache = ("int8" if dtype == "bf16" else "int8-f32") if quant else dtype
    pools, table, _, _, q = _setup(cache, G=G, seed=2 + G)
    pos = np.asarray([0, PS, MAXP * PS + 2], np.int32)
    slopes = _slopes(q.shape[1], alibi)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = jpaged.paged_flash_decode_pallas(
        _j(q), _j(pools[0]), _j(pools[1]), _j(table), _j(pos), jnp.int32(1),
        scale, alibi_slopes=_j(slopes), k_scale=_j(pools[2]),
        v_scale=_j(pools[3]), interpret=True)
    tp = [_t(a) for a in pools]
    got = tpaged.paged_flash_decode(t(q), tp[0], tp[1], t(table), t(pos), 1,
                                    scale, _t(slopes), tp[2], tp[3])
    assert got.dtype == t(q).dtype and got.shape == q.shape
    if dtype == "f32":
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    else:
        bf16_close(got, want, "K15 bf16")


def _fused_case(cache, pos, alibi, seed, B=3, G=2, page_fold=None):
    pools, table, kn, vn, q = _setup(cache, B=B, G=G, seed=seed)
    slopes = _slopes(q.shape[1], alibi)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = jpaged.paged_fused_decode_append_pallas(
        _j(q), _j(kn), _j(vn), _j(pools[0]), _j(pools[1]), _j(table),
        _j(pos), jnp.int32(1), scale, alibi_slopes=_j(slopes),
        k_scale=_j(pools[2]), v_scale=_j(pools[3]), page_fold=page_fold,
        interpret=True)
    tp = [_t(a) for a in pools]
    got = tpaged.paged_fused_decode_append(
        t(q), t(kn), t(vn), tp[0], tp[1], t(table),
        t(pos) if np.ndim(pos) else int(pos), 1, scale, _t(slopes), tp[2],
        tp[3], page_fold=page_fold)
    assert len(got) == len(want) and got[1] is tp[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(f32(g), f32(w))
    return got, want


def _close(got, want, cache):
    if cache == "bf16":
        bf16_close(got, want, "K5 bf16")
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "int8-f32"])
@pytest.mark.parametrize("alibi", [False, True])
def test_paged_fused_plain_matches_jax_kernel(cache, alibi):
    """K5's plain version == paged_fused_decode_append_pallas (interpret):
    the written pool and scale planes bit-identical, the output within
    1e-5 (f32 q) or the bf16 tolerance (bf16 q and pool)."""
    pos = np.asarray([5, PS + 9, 2 * PS + 1], np.int32)
    got, want = _fused_case(cache, pos, alibi, seed=3)
    _close(got[0], want[0], cache)


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_paged_fused_edge_positions(cache):
    """pos 0 (no cached row read), the last row of the first page, the
    first row of the second, the last row of the last page and beyond it
    (clamped to MAXP*PS - 1) round-trip through K5's plain version as
    through the Pallas kernel."""
    pos = np.asarray([0, PS - 1, PS, MAXP * PS - 1, MAXP * PS + 7], np.int32)
    got, want = _fused_case(cache, pos, False, seed=11, B=5)
    _close(got[0], want[0], cache)


@pytest.mark.parametrize("page_fold", [1, 2])
def test_paged_fused_scalar_pos_and_page_fold(page_fold):
    """A scalar pos broadcasts; the TPU kernel's page_fold is a schedule
    (the port ignores it), so every fold gives the same answer."""
    got, want = _fused_case("int8", np.int32(19), True, seed=21,
                            page_fold=page_fold)
    _close(got[0], want[0], "int8")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_attention_dispatch(monkeypatch, fused, quant):
    """paged_decode_attention follows FLASH_FUSED_APPEND as JAX's does:
    K5, or K14 then K15. Each route writes the JAX route's bytes and
    returns its output within 1e-5 (f32 q; bf16 scale planes, the serving
    default)."""
    cache = "int8" if quant else "f32"
    pools, table, kn, vn, q = _setup(cache, seed=31)
    pos = np.asarray([7, 2 * PS, MAXP * PS - 1], np.int32)
    monkeypatch.setattr(tattn, "FLASH_FUSED_APPEND", fused)
    monkeypatch.setattr(jattn, "FLASH_FUSED_APPEND", fused)
    want = jpaged.paged_decode_attention(
        _j(q), _j(kn), _j(vn), _j(pools[0]), _j(pools[1]), _j(table),
        _j(pos), jnp.int32(0), k_scale=_j(pools[2]), v_scale=_j(pools[3]),
        interpret=True)
    tp = [_t(a) for a in pools]
    got = tpaged.paged_decode_attention(
        t(q), t(kn), t(vn), tp[0], tp[1], t(table), t(pos), 0,
        k_scale=tp[2], v_scale=tp[3])
    assert len(got) == len(want)
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(f32(g), f32(w))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_paged_equals_contiguous(monkeypatch, fused, cache):
    """A pool holding the slot cache's rows page by page (row b's logical
    page j in physical page 1 + b*MAXP + j) gives decode_attention's
    output and writes its bytes, on both routes."""
    monkeypatch.setattr(tattn, "FLASH_FUSED_APPEND", fused)
    L, B, KV, D, S = 2, 3, 2, 64, MAXP * PS
    rng = np.random.RandomState(0)
    if cache == "int8":
        ck, ks = tattn._quant_rows(torch.from_numpy(rng.randn(L, B, KV, S, D)
                                                    .astype(np.float32)))
        cv, vs = tattn._quant_rows(torch.from_numpy(rng.randn(L, B, KV, S, D)
                                                    .astype(np.float32)))
        slot = [ck, cv, ks[..., 0].bfloat16(), vs[..., 0].bfloat16()]
    else:
        slot = [torch.from_numpy(rng.randn(L, B, KV, S, D).astype(np.float32))
                for _ in range(2)] + [None, None]
    q = torch.from_numpy(rng.randn(B, 2 * KV, D).astype(np.float32))
    kn, vn = (torch.from_numpy(rng.randn(B, KV, D).astype(np.float32))
              for _ in range(2))
    pos = torch.tensor([5, 30, 47], dtype=torch.int32)

    def to_pool(x):
        if x is None:
            return None
        pages = x.reshape(L, B, KV, MAXP, PS, *x.shape[4:]).transpose(2, 3)
        pages = pages.reshape(L, B * MAXP, KV, PS, *x.shape[4:])
        return torch.cat([torch.zeros_like(pages[:, :1]), pages], dim=1)

    pool = [to_pool(x) for x in slot]
    table = (1 + torch.arange(B * MAXP, dtype=torch.int32)).reshape(B, MAXP)
    want = tattn.decode_attention(q, kn, vn, slot[0], slot[1], pos, 1,
                                  k_scale=slot[2], v_scale=slot[3])
    got = tpaged.paged_decode_attention(q, kn, vn, pool[0], pool[1], table,
                                        pos, 1, k_scale=pool[2],
                                        v_scale=pool[3])
    np.testing.assert_array_equal(f32(got[0]), f32(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(f32(g), f32(to_pool(w)))
