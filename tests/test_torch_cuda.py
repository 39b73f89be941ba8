"""The port's CUDA kernels against their plain versions on the card, at
small shapes. These need an NVIDIA GPU and nvcc: elsewhere they skip.
On the machine with the card (which has no JAX, so without the suite's
conftest): ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py -q``."""

import math

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_close(got, ref):
    got, ref = got.float().cpu(), ref.float().cpu()
    tol = 1e-2 * ref.abs().max().item()
    torch.testing.assert_close(got, ref, rtol=2 ** -6, atol=tol)


@pytest.mark.parametrize("nbits", [2, 4, 7])
@pytest.mark.parametrize("pre", [None, "layernorm", "rmsnorm", "relu", "gelu",
                                 "silu_glu"])
@pytest.mark.parametrize("m", [3, 40])
@pytest.mark.parametrize("N", [200, 198])
def test_k1_matches_plain(dev, nbits, pre, m, N):
    from sleekit_tpu_torch.ops.dequant_matmul import (
        K1, pair_matmul, pair_matmul_plain)
    from sleekit_tpu_torch.ops.pack import pack_indices

    g = torch.Generator().manual_seed(nbits)
    K = 400
    idx = torch.randint(0, 2 ** nbits, (K, N), generator=g)
    packed = pack_indices(idx, nbits, layout="pair").to(dev)
    x = torch.randn(m, 2 * K if pre == "silu_glu" else K, generator=g).to(
        dev, torch.bfloat16)
    kw = dict(nbits=nbits, k=K, a_aff=0.125, b_aff=-1.0, pre=pre,
              ln_scale=torch.rand(K, generator=g).to(dev) + 0.5,
              ln_bias=torch.randn(K, generator=g).to(dev) * 0.1,
              residual=torch.randn(m, N, generator=g).to(dev, torch.bfloat16))
    scale = torch.rand(N, generator=g).to(dev) + 0.5
    bias = torch.randn(N, generator=g).to(dev)
    before = K1.launches
    got = pair_matmul(x, packed, scale, bias, **kw)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    _bf16_close(got, pair_matmul_plain(x, packed, scale, bias, **kw))


@pytest.mark.parametrize("pre", [None, "layernorm"])
@pytest.mark.parametrize("m", [2, 20])
def test_k2_matches_plain(dev, pre, m):
    from sleekit_tpu_torch.ops.dequant_matmul import (
        int8_matmul, int8_matmul_plain)
    from sleekit_tpu_torch.ops.pack import pack_indices

    g = torch.Generator().manual_seed(2)
    K, N = 200, 300
    packed = pack_indices(torch.randint(0, 256, (K, N), generator=g), 8,
                          layout="int8").to(dev)
    x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
    kw = dict(k=K, out_n=N, a_aff=2 / 255, b_aff=0.004, pre=pre,
              ln_scale=torch.ones(K, device=dev, dtype=torch.bfloat16),
              ln_bias=torch.zeros(K, device=dev, dtype=torch.bfloat16))
    scale = torch.rand(1024, generator=g).to(dev)
    got = int8_matmul(x, packed, scale, None, **kw)
    _bf16_close(got, int8_matmul_plain(x, packed, scale, None, **kw))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("ragged", [False, True])
def test_k3_matches_plain(dev, G, cache, ragged):
    from sleekit_tpu_torch.ops.attention import (
        _quant_rows, fused_decode_append, fused_decode_append_plain)

    g = torch.Generator().manual_seed(G)
    L, B, KV, S, D = 2, 3, 2, 300, 64
    k = torch.randn(L, B, KV, S, D, generator=g)
    v = torch.randn(L, B, KV, S, D, generator=g)
    ks = vs = None
    if cache == "int8":
        k, ks = _quant_rows(k)
        v, vs = _quant_rows(v)
        ks, vs = ks[..., 0].bfloat16(), vs[..., 0].bfloat16()
    else:
        dt = torch.bfloat16 if cache == "bf16" else torch.float32
        k, v = k.to(dt), v.to(dt)
    q = torch.randn(B, KV * G, D, generator=g).bfloat16()
    kn = torch.randn(B, KV, D, generator=g).bfloat16()
    vn = torch.randn(B, KV, D, generator=g).bfloat16()
    pos = torch.tensor([0, 137, S + 3], dtype=torch.int32) if ragged else 200
    slopes = torch.linspace(0.05, 0.9, KV * G)
    args = [q, kn, vn, k, v]
    planes = [ks, vs]
    want = fused_decode_append_plain(
        *[a.clone() for a in args], pos, 1, 1 / math.sqrt(D), slopes,
        *[None if p is None else p.clone() for p in planes])
    on = lambda a: None if a is None else a.to(dev)  # noqa: E731
    got = fused_decode_append(
        *[on(a) for a in args], on(pos) if ragged else pos, 1,
        1 / math.sqrt(D), on(slopes), *[on(p) for p in planes])
    torch.cuda.synchronize()
    _bf16_close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [256, 200])
def test_k4_matches_plain(dev, G, dtype, T):
    from sleekit_tpu_torch.ops.attention import (
        flash_prefill, flash_prefill_plain)

    g = torch.Generator().manual_seed(T + G)
    B, KV, D = 2, 2, 64
    q = torch.randn(B, T, KV * G, D, generator=g).to(dev, dtype)
    k = torch.randn(B, KV, T, D, generator=g).to(dev, dtype)
    v = torch.randn(B, KV, T, D, generator=g).to(dev, dtype)
    slopes = torch.linspace(0.02, 0.4, KV * G).to(dev)
    got = flash_prefill(q, k, v, 0.125, slopes)
    want = flash_prefill_plain(q, k, v, 0.125, slopes)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(got, want)


def _cache(g, shape, cache):
    """Random K and V caches of ``shape`` (L, P, KV, rows, D) and their
    scale planes (bf16; None unless int8)."""
    from sleekit_tpu_torch.ops.attention import _quant_rows

    k = torch.randn(*shape, generator=g)
    v = torch.randn(*shape, generator=g)
    if cache == "int8":
        k, ks = _quant_rows(k)
        v, vs = _quant_rows(v)
        return [k, v, ks[..., 0].bfloat16(), vs[..., 0].bfloat16()]
    dt = torch.bfloat16 if cache == "bf16" else torch.float32
    return [k.to(dt), v.to(dt), None, None]


def _on(dev, a):
    return None if a is None else a.to(dev)


@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_kv_append_matches_plain(dev, cache, ragged, paged):
    """K10 (slot cache) and K14 (page pool, through a table of distinct
    pages in random order) write the plain version's bytes."""
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import paged_attention as pa

    g = torch.Generator().manual_seed(3)
    L, B, KV, D, PS, MAXP = 2, 3, 2, 64, 64, 4
    P = B * MAXP + 1 if paged else B
    planes = _cache(g, (L, P, KV, PS if paged else 300, D), cache)
    dt = torch.float32 if cache == "f32" else torch.bfloat16
    kn = torch.randn(B, KV, D, generator=g).to(dt)
    vn = torch.randn(B, KV, D, generator=g).to(dt)
    pos = torch.tensor([0, 137, 1000], dtype=torch.int32) if ragged else 200
    tpos = _on(dev, pos) if ragged else pos
    got = [_on(dev, p) for p in planes]
    want = [None if p is None else p.clone() for p in planes]
    if paged:
        table = (1 + torch.randperm(P - 1, generator=g)).to(torch.int32)
        table = table.reshape(B, MAXP)
        kernel = pa.K14
        before = kernel.launches
        pa.paged_kv_append(kn.to(dev), vn.to(dev), got[0], got[1],
                           table.to(dev), tpos, 1, got[2], got[3])
        pa.paged_kv_append_plain(kn, vn, want[0], want[1], table, pos, 1,
                                 want[2], want[3])
    else:
        kernel = at.K10
        before = kernel.launches
        at.kv_append(kn.to(dev), vn.to(dev), got[0], got[1], tpos, 1,
                     got[2], got[3])
        at.kv_append_plain(kn, vn, want[0], want[1], pos, 1, want[2],
                           want[3])
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for a, b in zip(got, want):
        if b is not None:
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_flash_decode_matches_plain(dev, G, cache, ragged, paged):
    """K11 (slot cache) and K15 (page pool) against their plain versions:
    rows s <= pos, ALiBi, GQA; bf16 q within the bf16 tolerance, f32 q
    (f32 cache) within 1e-5."""
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import paged_attention as pa

    g = torch.Generator().manual_seed(G)
    L, B, KV, D, PS, MAXP = 2, 3, 2, 64, 64, 5
    P = B * MAXP + 1 if paged else B
    planes = _cache(g, (L, P, KV, PS if paged else 300, D), cache)
    dt = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.randn(B, KV * G, D, generator=g).to(dt)
    pos = torch.tensor([0, 137, 1000], dtype=torch.int32) if ragged else 200
    slopes = torch.linspace(0.05, 0.9, KV * G)
    scale = 1 / math.sqrt(D)
    dplanes = [_on(dev, p) for p in planes]
    tpos = _on(dev, pos) if ragged else pos
    if paged:
        table = (1 + torch.randperm(P - 1, generator=g)).to(torch.int32)
        table = table.reshape(B, MAXP)
        got = pa.paged_flash_decode(q.to(dev), dplanes[0], dplanes[1],
                                    table.to(dev), tpos, 1, scale,
                                    slopes.to(dev), dplanes[2], dplanes[3])
        want = pa.paged_flash_decode_plain(q, planes[0], planes[1], table,
                                           pos, 1, scale, slopes, planes[2],
                                           planes[3])
    else:
        got = at.flash_decode(q.to(dev), dplanes[0], dplanes[1], tpos, 1,
                              scale, slopes.to(dev), dplanes[2], dplanes[3])
        want = at.flash_decode_plain(q, planes[0], planes[1], pos, 1, scale,
                                     slopes, planes[2], planes[3])
    torch.cuda.synchronize()
    if dt == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("ragged", [False, True])
def test_k5_matches_plain_and_k3(dev, G, cache, ragged):
    """K5 against its plain version (output within the bf16 tolerance,
    written bytes equal), and against K3 on the same logical rows: output
    and written bytes bit-identical."""
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import paged_attention as pa

    g = torch.Generator().manual_seed(10 + G)
    L, B, KV, D, PS, MAXP = 2, 3, 2, 64, 64, 5
    S = PS * MAXP
    slot = _cache(g, (L, B, KV, S, D), cache)
    dt = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.randn(B, KV * G, D, generator=g).to(dt)
    kn = torch.randn(B, KV, D, generator=g).to(dt)
    vn = torch.randn(B, KV, D, generator=g).to(dt)
    pos = (torch.tensor([0, PS, S + 3], dtype=torch.int32) if ragged
           else PS - 1)
    slopes = torch.linspace(0.05, 0.9, KV * G)
    scale = 1 / math.sqrt(D)
    # Row b's logical page j lives in physical page table[b, j], out of
    # order; page 0 stays unused.
    table = (1 + torch.randperm(B * MAXP, generator=g)).to(torch.int32)
    table = table.reshape(B, MAXP)

    def to_pool(x):
        if x is None:
            return None
        pages = x.reshape(L, B, KV, MAXP, PS, *x.shape[4:]).transpose(2, 3)
        pages = pages.reshape(L, B * MAXP, KV, PS, *x.shape[4:])
        pool = torch.zeros((L, B * MAXP + 1) + pages.shape[2:],
                           dtype=x.dtype)
        pool[:, table.reshape(-1).long()] = pages
        return pool

    pool = [to_pool(x) for x in slot]
    want = pa.paged_fused_decode_append_plain(
        q, kn, vn, *[None if p is None else p.clone() for p in pool[:2]],
        table, pos, 1, scale, slopes,
        *[None if p is None else p.clone() for p in pool[2:]])
    dpool = [_on(dev, p) for p in pool]
    dslot = [_on(dev, p) for p in slot]
    tpos = _on(dev, pos) if ragged else pos
    before = pa.K5.launches
    got = pa.paged_fused_decode_append(
        q.to(dev), kn.to(dev), vn.to(dev), dpool[0], dpool[1],
        table.to(dev), tpos, 1, scale, slopes.to(dev), dpool[2], dpool[3])
    k3 = at.fused_decode_append(q.to(dev), kn.to(dev), vn.to(dev), dslot[0],
                                dslot[1], tpos, 1, scale, slopes.to(dev),
                                dslot[2], dslot[3])
    torch.cuda.synchronize()
    assert pa.K5.launches == before + 1
    if dt == torch.float32:
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5,
                                   atol=1e-5)
    else:
        _bf16_close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(got[0], k3[0])
    for a, b in zip(got[1:], k3[1:]):
        assert torch.equal(a.cpu(), to_pool(b.cpu()))


@pytest.mark.parametrize("layout,K", [("pair3", 400), ("pair3", 1792),
                                      ("pair3x", 1536)])
@pytest.mark.parametrize("pre", [None, "layernorm", "relu", "silu_glu"])
@pytest.mark.parametrize("m", [1, 8, 1024])
@pytest.mark.parametrize("N", [200, 198])
def test_k6_k7_match_plain(dev, layout, K, pre, m, N):
    """K7 ('pair3', K not a multiple of its 256-row tile at 400) and K6
    ('pair3x') against their plain version, with a prologue and a
    residual, N not a multiple of the 16- or 64-column block."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import pack_indices

    g = torch.Generator().manual_seed(K + N)
    idx = torch.randint(0, 8, (K, N), generator=g)
    packed = pack_indices(idx, 3, layout=layout).to(dev)
    x = torch.randn(m, 2 * K if pre == "silu_glu" else K, generator=g).to(
        dev, torch.bfloat16)
    kw = dict(k=K, a_aff=0.25, b_aff=-1.0, pre=pre, layout=layout,
              ln_scale=torch.rand(K, generator=g).to(dev) + 0.5,
              ln_bias=torch.randn(K, generator=g).to(dev) * 0.1,
              residual=torch.randn(m, N, generator=g).to(dev, torch.bfloat16))
    scale = torch.rand(N, generator=g).to(dev) + 0.5
    bias = torch.randn(N, generator=g).to(dev)
    kernel = dm.K6 if layout == "pair3x" else dm.K7
    before = kernel.launches
    got = dm.pair3_matmul(x, packed, scale, bias, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _bf16_close(got, dm.pair3_matmul_plain(x, packed, scale, bias, **kw))


@pytest.mark.parametrize("codebook", ["nf4", "table3", "table8", "affine8",
                                      "uniform3", "uniform4"])
@pytest.mark.parametrize("m", [1, 8, 1024])
@pytest.mark.parametrize("N", [200, 198])
def test_k8_k9_match_plain(dev, codebook, m, N):
    """K8 (tables: NF4, a k = 3 table at 2 bits, an unsorted 8-entry
    table; and the 8-bit affine grid) and K9 (uniform 3 and 4 bits) on
    'plane' words against their plain versions, K (700) not a multiple of
    any plane tile, N not a multiple of the block."""
    from sleekit_tpu_torch.codebooks import Codebook
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import bits_for_codebook, pack_indices

    g = torch.Generator().manual_seed(N)
    K = 700
    lut = {"nf4": Codebook.nf4().values,
           "table3": torch.tensor([-1.0, 0.1, 1.0]),
           "table8": torch.tensor([0.3, -1.0, 0.7, 0.05, -0.4, 1.0, -0.1,
                                   0.5]),
           "affine8": torch.linspace(-1, 1, 256),
           "uniform3": torch.linspace(-1, 1, 8),
           "uniform4": torch.linspace(-1, 1, 16)}[codebook]
    nbits = bits_for_codebook(lut.numel())
    packed = pack_indices(torch.randint(0, lut.numel(), (K, N), generator=g),
                          nbits, layout="plane").to(dev)
    x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
    scale = torch.rand(N, generator=g).to(dev) + 0.5
    bias = torch.randn(N, generator=g).to(dev)
    if codebook.startswith("uniform"):
        kernel, fn, plain = dm.K9, dm.plane_affine_matmul, \
            dm.plane_affine_matmul_plain
        step = 2.0 / (lut.numel() - 1)
        kw = dict(nbits=nbits, k=K, a_aff=step * 2 ** nbits,
                  b_aff=-1.0 - step * 2 ** nbits)
    else:
        kernel, fn, plain = dm.K8, dm.plane_lut_matmul, \
            dm.plane_lut_matmul_plain
        kw = dict(nbits=nbits, k=K,
                  affine=(2.0 / 255, -1.0) if codebook == "affine8" else None)
        lut = lut.to(dev)
    args = (x, packed, scale, bias) + (() if kernel is dm.K9 else (lut,))
    before = kernel.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _bf16_close(got, plain(*args, **kw))
