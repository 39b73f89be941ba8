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


def _ulp_misses(got, ref):
    """Elements of a bf16 ``got`` more than one bf16 step (rtol 2^-7) plus
    2^-14 max|ref| away from ``ref``: the bound for two f32 computations
    of one function, each rounded once to bf16 at the end."""
    got, ref = got.float().cpu(), ref.float().cpu()
    tol = 2 ** -7 * ref.abs() + 2 ** -14 * ref.abs().max()
    return int(((got - ref).abs() > tol).sum())


# Positions at the decode kernels' split edges (R rows a split,
# ``ops/attention.py`` ``decode_plan``): 0, R - 1, R, R + 1, the last row of
# the capacity, and a ragged vector that mixes them (with one past the
# capacity, clamped to its last row).
_EDGES = ["0", "R-1", "R", "R+1", "last", "ragged"]

# Head dims and query heads a KV head of the decode kernels' tests. The
# lanes that read a row (``decode_lanes``) run from 1 to 32, with two
# 16-byte chunks a lane in f32 rows at D 256; D 36 leaves int8 and bf16
# rows off the 16-byte grid (the element-by-element loads); G 8 takes two
# passes of 4 query heads.
_DECODE_D = [36, 64, 80, 128, 256]
_DECODE_G = [1, 4, 8]


def _edge_pos(edge, B, KV, G, D, itemsize, capacity):
    from sleekit_tpu_torch.ops.attention import decode_plan

    R = decode_plan(B, KV, G, D, itemsize, capacity)[0]
    vals = {"0": 0, "R-1": R - 1, "R": R, "R+1": R + 1,
            "last": capacity - 1}
    if edge != "ragged":
        return vals[edge]
    mix = [0, R - 1, R, R + 1, capacity - 1, 10 * capacity]
    return torch.tensor([mix[i % len(mix)] for i in range(B)],
                        dtype=torch.int32)


def _to_pool(x, table, PS):
    """A slot-cache plane (L, B, KV, S[, D]) laid out page by page into a
    pool (L, B*S/PS + 1, KV, PS[, D]) through ``table`` (B, S/PS); page 0
    stays unused."""
    if x is None:
        return None
    L, B, KV, S = x.shape[:4]
    MAXP = S // PS
    pages = x.reshape(L, B, KV, MAXP, PS, *x.shape[4:]).transpose(2, 3)
    pages = pages.reshape(L, B * MAXP, KV, PS, *x.shape[4:])
    pool = torch.zeros((L, B * MAXP + 1) + pages.shape[2:], dtype=x.dtype,
                       device=x.device)
    pool[:, table.reshape(-1).long()] = pages
    return pool


# (nbits, m, N, glue) of K1's cases: the decode route (m <= 8) at every
# nbits, N and glue; the tensor-core route at 2, 4 and 7 bits with glue.
_K1_CASES = (
    [(nb, m, N, glue) for nb in range(1, 8) for m in (1, 3, 8)
     for N in (200, 198, 1029) for glue in (True, False)]
    + [(nb, m, N, True) for nb in (2, 4, 7) for m in (9, 40, 64, 1024)
       for N in (200, 198)])


@pytest.mark.parametrize("nbits,m,N,glue", _K1_CASES)
@pytest.mark.parametrize("pre", [None, "layernorm", "rmsnorm", "relu", "gelu",
                                 "silu_glu"])
def test_k1_matches_plain(dev, nbits, pre, m, N, glue):
    """K1 against its plain version: the decode route (m <= 8: the
    prologue pass and the streaming kernel) and the tensor-core route (m >
    8, here in 32 x 64 tiles), with and without (``glue``) a bias and a
    residual. K ends inside a pair tile and is not a multiple of the
    64-row stage (400; with N = 198, 396: not a multiple of 8 either, so
    the prologue pass takes one column a thread); N is not a multiple of
    the 32-column strip at 200 and 1029, nor of 4 at 198 and 1029 (4-byte
    word loads), and odd at 1029 (one output column at a time)."""
    from sleekit_tpu_torch.ops.dequant_matmul import (
        K1, pair_matmul, pair_matmul_plain)
    from sleekit_tpu_torch.ops.pack import pack_indices

    g = torch.Generator().manual_seed(nbits)
    K = 396 if N == 198 else 400
    idx = torch.randint(0, 2 ** nbits, (K, N), generator=g)
    packed = pack_indices(idx, nbits, layout="pair").to(dev)
    x = torch.randn(m, 2 * K if pre == "silu_glu" else K, generator=g).to(
        dev, torch.bfloat16)
    kw = dict(nbits=nbits, k=K, a_aff=0.125, b_aff=-1.0, pre=pre,
              ln_scale=torch.rand(K, generator=g).to(dev) + 0.5,
              ln_bias=torch.randn(K, generator=g).to(dev) * 0.1,
              residual=torch.randn(m, N, generator=g).to(dev, torch.bfloat16)
              if glue else None)
    scale = torch.rand(N, generator=g).to(dev) + 0.5
    bias = torch.randn(N, generator=g).to(dev) if glue else None
    before = K1.launches
    got = pair_matmul(x, packed, scale, bias, **kw)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    _bf16_close(got, pair_matmul_plain(x, packed, scale, bias, **kw))


@pytest.mark.parametrize("layout", ["pair", "pair3", "pair3x"])
@pytest.mark.parametrize("m,N", [(1024, 1032), (1024, 1029), (2048, 4232),
                                 (2048, 4230)])
def test_k1_k6_k7_tile_rules(dev, layout, m, N):
    """K1, K7 and K6 in the tensor-core route's 128 x 128 tiles, one block
    an SM (8 x 9 blocks) and two (16 x 34, at least twice the SMs), with
    16-byte word copies (N % 4 == 0) and 4-byte ones (N = 1029, 4230; at
    odd N the outputs are stored one at a time), against their plain
    versions, with a layernorm prologue and a residual."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import pack_indices

    g = torch.Generator().manual_seed(N)
    K, nbits = 512, 4 if layout == "pair" else 3
    packed = pack_indices(torch.randint(0, 2 ** nbits, (K, N), generator=g),
                          nbits, layout=layout).to(dev)
    x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
    kw = dict(k=K, a_aff=0.25, b_aff=-1.0, pre="layernorm",
              ln_scale=torch.rand(K, generator=g).to(dev) + 0.5,
              ln_bias=torch.randn(K, generator=g).to(dev) * 0.1,
              residual=torch.randn(m, N, generator=g).to(dev, torch.bfloat16))
    scale = torch.rand(N, generator=g).to(dev) + 0.5
    bias = torch.randn(N, generator=g).to(dev)
    if layout == "pair":
        kernel, fn, plain = dm.K1, dm.pair_matmul, dm.pair_matmul_plain
        kw["nbits"] = nbits
    else:
        kernel = dm.K6 if layout == "pair3x" else dm.K7
        fn, plain = dm.pair3_matmul, dm.pair3_matmul_plain
        kw["layout"] = layout
    before = kernel.launches
    got = fn(x, packed, scale, bias, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _bf16_close(got, plain(x, packed, scale, bias, **kw))


def _decode_call(dev, g, kernel, K, N, m, nbits=4):
    """(kernel, call, plain): a call of K1 (int4 'pair', layernorm
    prologue and a residual), K8 (NF4 'plane') or K9 (uniform int4
    'plane') on random (K, N) words and x (m, K), and its plain version;
    ``call(x)`` and ``plain(x)`` take the input."""
    from sleekit_tpu_torch.codebooks import Codebook
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import pack_indices

    layout = "pair" if kernel == "K1" else "plane"
    packed = pack_indices(torch.randint(0, 2 ** nbits, (K, N), generator=g),
                          nbits, layout=layout).to(dev)
    scale = torch.rand(N, generator=g).to(dev) + 0.5
    if kernel == "K1":
        kw = dict(nbits=nbits, k=K, a_aff=0.125, b_aff=-1.0,
                  pre="layernorm",
                  ln_scale=torch.rand(K, generator=g).to(dev) + 0.5,
                  residual=torch.randn(m, N, generator=g).to(
                      dev, torch.bfloat16))
        fn, plain, args = dm.pair_matmul, dm.pair_matmul_plain, ()
    elif kernel == "K8":
        kw = dict(nbits=nbits, k=K)
        fn, plain = dm.plane_lut_matmul, dm.plane_lut_matmul_plain
        args = (Codebook.nf4().values.to(dev),)
    else:
        kw = dict(nbits=nbits, k=K, a_aff=0.125, b_aff=-1.0)
        fn, plain, args = dm.plane_affine_matmul, \
            dm.plane_affine_matmul_plain, ()
    return (getattr(dm, kernel),
            lambda x: fn(x, packed, scale, None, *args, **kw),
            lambda x: plain(x, packed, scale, None, *args, **kw))


@pytest.mark.parametrize("kernel", ["K1", "K8", "K9"])
@pytest.mark.parametrize("m", [8, 64])
def test_k1_replays_in_cuda_graph(dev, kernel, m):
    """K1, K8 and K9 on both routes captured in a CUDA graph: the
    prologue's scratch and, at M = 8 (2048 x 256: K split over blocks),
    the split-K partials and tickets are set up under capture, and two
    replays after x changes in place each give the eager call's output
    for the new x (the prologue pass zeroes the tickets on every
    replay)."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm

    g = torch.Generator().manual_seed(5)
    K, N = (2048, 256) if m <= dm.DECODE_M else (512, 256)
    kern, call_x, _ = _decode_call(dev, g, kernel, K, N, m)
    if m <= dm.DECODE_M:   # 4-bit words: K/8 word rows in both layouts
        layout = "pair" if kernel == "K1" else "plane"
        assert dm._scratch(torch.empty(m, K, device=dev), K, N, K // 8,
                           layout, 4)[1] > 1
    x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)

    def call():
        return call_x(x)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kern.launches
    with torch.cuda.graph(graph):
        out = call()
    assert kern.launches == before + 1
    for _ in range(2):
        x.copy_(torch.randn(m, K, generator=g).to(dev, torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())


@pytest.mark.parametrize("kernel", ["K1", "K8", "K9"])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("K,N", [(2048, 2048), (8192, 2048)])
def test_k1_stream_is_deterministic(dev, kernel, m, K, N):
    """K1's, K8's and K9's streaming route at OPT-1.3B's o and fc2 shapes,
    where K is split over blocks: within the bf16 tolerance of the plain
    version, and bit for bit the same on a second call (the warps' and
    the splits' partial sums are added in a fixed order)."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm

    g = torch.Generator().manual_seed(K + m)
    _, call, plain = _decode_call(dev, g, kernel, K, N, m)
    x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
    layout = "pair" if kernel == "K1" else "plane"
    assert dm._scratch(x, K, N, K // 8, layout, 4)[1] > 1
    got = call(x)
    assert torch.equal(got, call(x))
    _bf16_close(got, plain(x))


@pytest.mark.parametrize("m", [4, 16])
def test_k1_k6_k7_raise_without_scratch(dev, m):
    """A launch of K1, K6, K7, K8 or K9 without the prologue pass's
    scratch pointers, on the streaming route (m = 4) and the tensor-core
    route (m = 16), returns a CUDA error that the kernel's binding raises;
    nothing falls back."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import pack_indices

    K, N = 512, 64
    x = torch.zeros(m, K, device=dev, dtype=torch.bfloat16)
    scale = torch.ones(N, device=dev)
    lut = torch.linspace(-1, 1, 16, device=dev)
    out = torch.empty(m, N, device=dev, dtype=torch.bfloat16)
    idx = torch.zeros(K, N, dtype=torch.int64)
    for kernel, layout, nbits in ((dm.K1, "pair", 4), (dm.K6, "pair3x", 3),
                                  (dm.K7, "pair3", 3)):
        packed = pack_indices(idx, nbits, layout=layout).to(dev)
        head = (x.data_ptr(), packed.data_ptr(), scale.data_ptr(), 0, 0, 0,
                0, 0, out.data_ptr(), 0, 0, 0, 0, m, N, K, K,
                packed.shape[0], 1)
        tail = ((nbits,) if kernel is dm.K1 else ()) + (0, 1.0, 0.0, 1e-5)
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernel(*head, *tail)
    packed = pack_indices(idx, 4, layout="plane").to(dev)
    kw = packed.shape[0]
    with pytest.raises(RuntimeError, match="CUDA error"):
        dm.K8(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), 0,
              lut.data_ptr(), out.data_ptr(), 0, 0, 0, 0, m, N, K, kw, 1, 4,
              16, 0.0, 0.0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        dm.K9(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), 0,
              out.data_ptr(), 0, 0, 0, 0, m, N, K, kw, 1, 4, 1.0, 0.0)


def _k2_head(g, dev, K, N, narrow):
    """An int8 head of K x N: packed by ``pack_indices`` (K rounded up to
    32 rows, N to 1024 columns), or with ``narrow`` a bare (K, N) byte
    matrix (N not a multiple of 16: the kernels copy one byte at a time)."""
    from sleekit_tpu_torch.ops.pack import pack_indices

    idx = torch.randint(0, 256, (K, N), generator=g)
    if narrow:
        return (idx - 128).to(torch.int8).to(dev)
    return pack_indices(idx, 8, layout="int8").to(dev)


def _k2_args(g, dev, K, m, n, pre, glue):
    x = torch.randn(m, K, generator=g).to(dev, torch.bfloat16)
    kw = dict(k=K, out_n=n, a_aff=2 / 255, b_aff=0.004, pre=pre,
              ln_scale=torch.rand(K, generator=g).to(dev, torch.bfloat16)
              + 0.5,
              ln_bias=(torch.randn(K, generator=g) * 0.1).to(
                  dev, torch.bfloat16) if pre == "layernorm" else None)
    if glue:
        kw["residual"] = torch.randn(m, n, generator=g).to(dev,
                                                           torch.bfloat16)
    return x, kw


@pytest.mark.parametrize("m", [2, 8, 20, 64, 130])
@pytest.mark.parametrize("pre", [None, "layernorm", "rmsnorm"])
@pytest.mark.parametrize("glue", [False, True])
@pytest.mark.parametrize("narrow", [False, True])
def test_k2_matches_plain(dev, m, pre, glue, narrow):
    """K2 against its plain version: the streaming route (m <= 8) and the
    tensor-core route (m > 8, here in 32 x 64 tiles), with and without
    bias and residual. Packed, K = 200 gives Kp = 224 rows, below the 256
    columns of the prologue's scratch (rows 224-255 must arrive as zeros),
    and out_n = 300 ends inside a tile of Np = 1024; ``narrow``: a bare
    (200, 300) byte matrix, out_n = 290."""
    from sleekit_tpu_torch.ops.dequant_matmul import (
        K2, int8_matmul, int8_matmul_plain)

    g = torch.Generator().manual_seed(m)
    K, N = 200, 300
    packed = _k2_head(g, dev, K, N, narrow)
    assert packed.shape == ((200, 300) if narrow else (224, 1024))
    n = 290 if narrow else N
    x, kw = _k2_args(g, dev, K, m, n, pre, glue)
    scale = torch.rand(packed.shape[1], generator=g).to(dev)
    bias = torch.randn(packed.shape[1], generator=g).to(dev) if glue else None
    before = K2.launches
    got = int8_matmul(x, packed, scale, bias, **kw)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    assert got.shape == (m, n)
    _bf16_close(got, int8_matmul_plain(x, packed, scale, bias, **kw))


@pytest.mark.parametrize("m,N", [(64, 17000), (130, 34000), (1024, 4300)])
@pytest.mark.parametrize("narrow", [False, True])
def test_k2_tile_rules(dev, m, N, narrow):
    """K2's tensor-core tiles at enough columns to take them: 64 x 128
    (m = 64: 133 blocks) and 128 x 128 at two blocks an SM (m = 130: 2 x
    266 blocks; m = 1024: 8 x 34), with 16-byte copies (packed) and
    one-byte ones (``narrow``: N + 1 columns), against the plain version
    with a layernorm prologue and a residual."""
    from sleekit_tpu_torch.ops.dequant_matmul import (
        int8_matmul, int8_matmul_plain)

    g = torch.Generator().manual_seed(N)
    K = 256
    packed = _k2_head(g, dev, K, N + 1 if narrow else N, narrow)
    x, kw = _k2_args(g, dev, K, m, N, "layernorm", True)
    scale = torch.rand(packed.shape[1], generator=g).to(dev)
    got = int8_matmul(x, packed, scale, None, **kw)
    _bf16_close(got, int8_matmul_plain(x, packed, scale, None, **kw))


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("K,N", [(1024, 300), (2048, 4000)])
def test_k2_stream_is_deterministic(dev, m, K, N):
    """K2's streaming route over few 128-column strips and long K: within
    the bf16 tolerance of the plain version, and bit for bit the same on
    a second call (the warps' K slices are added in a fixed order)."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm

    g = torch.Generator().manual_seed(K + m)
    packed = _k2_head(g, dev, K, N, False)
    x, kw = _k2_args(g, dev, K, m, N, "layernorm", True)
    scale = torch.rand(packed.shape[1], generator=g).to(dev)
    got = dm.int8_matmul(x, packed, scale, None, **kw)
    assert torch.equal(got, dm.int8_matmul(x, packed, scale, None, **kw))
    _bf16_close(got, dm.int8_matmul_plain(x, packed, scale, None, **kw))


@pytest.mark.parametrize("m", [8, 64])
def test_k2_replays_in_cuda_graph(dev, m):
    """K2 on both routes (its wrapper allocates the prologue's scratch at
    every M) captured in a CUDA graph: a replay after x changes in place
    gives the eager call's output for the new x."""
    from sleekit_tpu_torch.ops.dequant_matmul import K2, int8_matmul

    g = torch.Generator().manual_seed(7)
    K, N = 512, 3000
    packed = _k2_head(g, dev, K, N, False)
    x, kw = _k2_args(g, dev, K, m, N, "layernorm", False)
    scale = torch.rand(packed.shape[1], generator=g).to(dev)

    def call():
        return int8_matmul(x, packed, scale, None, **kw)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = K2.launches
    with torch.cuda.graph(graph):
        out = call()
    assert K2.launches == before + 1
    x.copy_(torch.randn(m, K, generator=g).to(dev, torch.bfloat16))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())


def test_k2_raises_without_scratch(dev):
    """A K2 launch without the prologue's scratch, at M > 8 and at M = 8
    (whose streaming route reads it too), returns a CUDA error that the
    binding raises; nothing falls back."""
    from sleekit_tpu_torch.ops.dequant_matmul import K2

    K, N = 512, 1024
    w8 = torch.zeros(K, N, device=dev, dtype=torch.int8)
    scale = torch.ones(N, device=dev)
    for m in (16, 8):
        x = torch.zeros(m, K, device=dev, dtype=torch.bfloat16)
        out = torch.empty(m, N, device=dev, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="CUDA error"):
            K2(x.data_ptr(), w8.data_ptr(), scale.data_ptr(), 0, 0, 0, 0, 0,
               out.data_ptr(), 0, 0, m, N, K, K, N, 0, 1.0, 0.0, 1e-5)


@pytest.mark.parametrize("G", _DECODE_G)
@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("edge", _EDGES)
@pytest.mark.parametrize("D", _DECODE_D)
def test_k3_matches_plain(dev, G, cache, edge, D):
    """K3 against its plain version at the split edges (``_edge_pos``) and
    the head dims of ``_DECODE_D``: output within the bf16 tolerance,
    written bytes equal."""
    from sleekit_tpu_torch.ops.attention import (
        _quant_rows, fused_decode_append, fused_decode_append_plain)

    g = torch.Generator().manual_seed(G + D)
    L, B, KV, S = 2, 6, 2, 320
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
    pos = _edge_pos(edge, B, KV, G, D, k.element_size(), S)
    slopes = torch.linspace(0.05, 0.9, KV * G)
    args = [q, kn, vn, k, v]
    planes = [ks, vs]
    want = fused_decode_append_plain(
        *[a.clone() for a in args], pos, 1, 1 / math.sqrt(D), slopes,
        *[None if p is None else p.clone() for p in planes])
    on = lambda a: None if a is None else a.to(dev)  # noqa: E731
    got = fused_decode_append(
        *[on(a) for a in args], _on(dev, pos) if edge == "ragged" else pos,
        1, 1 / math.sqrt(D), on(slopes), *[on(p) for p in planes])
    torch.cuda.synchronize()
    _bf16_close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)


def _k4_args(dev, dtype, B, T, KV, G, D, seed, alibi=True):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, T, KV * G, D, generator=g).to(dev, dtype)
    k = torch.randn(B, KV, T, D, generator=g).to(dev, dtype)
    v = torch.randn(B, KV, T, D, generator=g).to(dev, dtype)
    slopes = torch.linspace(0.02, 0.4, KV * G).to(dev) if alibi else None
    return q, k, v, slopes


# K4's cases (G, dtype, T, D, ALiBi, the mean of q and k): every
# combination at mean 0, and f32 at large logits (mean 1: logits about
# sqrt(D) against about 1; ALiBi at T 1024, slope 0.4, a bias down to
# -409) at each head dim.
_K4_CASES = [(G, dtype, T, D, alibi, 0.0)
             for alibi in (False, True) for D in (64, 80, 128)
             for T in (256, 200, 1024)
             for dtype in (torch.bfloat16, torch.float32) for G in (1, 4)]
_K4_CASES += [(4, torch.float32, 1024, D, True, 1.0) for D in (64, 80, 128)]


@pytest.mark.parametrize("G,dtype,T,D,alibi,mean", _K4_CASES)
def test_k4_matches_plain(dev, G, dtype, T, D, alibi, mean):
    """K4 against its plain version: bf16 on the tensor cores, f32 as split
    TF32 on the tensor cores; T = 200 leaves a ragged last tile and
    chunk. At mean 1 the f32 plain version is itself within the gate of
    the exact answer, so the kernel is held to it there at every head
    dim (mean 3, where it is not: test_k4_f32_large_logits_vs_exact)."""
    from sleekit_tpu_torch.ops.attention import (
        flash_prefill, flash_prefill_plain)

    q, k, v, slopes = _k4_args(dev, dtype, 2, T, 2, G, D, T + G + D, alibi)
    q, k = q + mean, k + mean
    got = flash_prefill(q, k, v, D ** -0.5, slopes)
    want = flash_prefill_plain(q, k, v, D ** -0.5, slopes)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("D", [64, 128])
def test_k4_f32_large_logits_vs_exact(dev, D):
    """q and k of mean 3 (logits about 9 sqrt(D)), ALiBi at T 1024, G 4:
    the f32 plain version is itself past the 1e-5 gate from the exact
    answer (chip_smoke.py check_k4_f32_large_logits prints by how much),
    so no f32 route can be held to it there; K4's f32 route stays as close
    to the exact answer as the plain version: its largest error over the
    gate's allowance at most 1.5x the plain version's
    (tests/test_torch_prefill_f32.py models the same on the CPU)."""
    from sleekit_tpu_torch.experiments.prefill_bench import (
        k4_exact, k4_gate)
    from sleekit_tpu_torch.ops.attention import (
        flash_prefill, flash_prefill_plain)

    q, k, v, slopes = _k4_args(dev, torch.float32, 2, 1024, 2, 4, D, 3 + D)
    q, k = q + 3.0, k + 3.0
    exact = k4_exact(q, k, v, D ** -0.5, slopes)
    got = k4_gate(flash_prefill(q, k, v, D ** -0.5, slopes), exact)
    plain = k4_gate(flash_prefill_plain(q, k, v, D ** -0.5, slopes), exact)
    assert plain > 1.0
    assert got <= 1.5 * plain, (got, plain)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,G", [(16, 1), (48, 2), (64, 4), (112, 1),
                                 (128, 4)])
def test_k4_row0_is_v_row0(dev, dtype, D, G):
    """Row 0 attends to column 0 alone (p = 1, sum 1), so K4's output row 0
    is V's row 0 of its KV head, bit for bit."""
    from sleekit_tpu_torch.ops.attention import flash_prefill

    q, k, v, slopes = _k4_args(dev, dtype, 2, 130, 2, G, D, D + G)
    got = flash_prefill(q, k, v, D ** -0.5, slopes)
    want = v[:, :, 0].repeat_interleave(G, dim=1)
    assert torch.equal(got[:, 0], want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k4_is_deterministic(dev, dtype):
    """Two launches on the same inputs give the same bits."""
    from sleekit_tpu_torch.ops.attention import flash_prefill

    q, k, v, slopes = _k4_args(dev, dtype, 2, 300, 2, 4, 128, 7)
    a = flash_prefill(q, k, v, 0.1, slopes)
    b = flash_prefill(q, k, v, 0.1, slopes)
    assert torch.equal(a, b)


@pytest.mark.parametrize("D", [40, 136])
def test_k4_bf16_head_dim_raises(dev, D):
    """The bf16 route takes D % 16 == 0 and D <= 128 and raises on any
    other head dim; it hands nothing to another body."""
    from sleekit_tpu_torch.ops.attention import K4, flash_prefill

    q, k, v, _ = _k4_args(dev, torch.bfloat16, 1, 64, 1, 1, D, 0)
    before = K4.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_prefill(q, k, v, 0.1)
    assert K4.launches == before


@pytest.mark.parametrize("D", [66, 132])
def test_k4_f32_head_dim_raises(dev, D):
    """The f32 route takes D % 4 == 0 and D <= 128 and raises on any other
    head dim before a launch."""
    from sleekit_tpu_torch.ops.attention import K4, flash_prefill

    q, k, v, _ = _k4_args(dev, torch.float32, 1, 64, 1, 1, D, 0)
    before = K4.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        flash_prefill(q, k, v, 0.1)
    assert K4.launches == before


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


def _prefill_rows(g, dev, B, T, H, KV, D, dtype, offset=0):
    """k and v (B, T, KV, D) on ``dev`` as the model slices them out of a
    fused qkv output (B, T, H*D + 2*KV*D), which starts ``offset``
    elements into its storage (1 leaves the rows 2- or 4-byte aligned
    only)."""
    d, kvd = H * D, KV * D
    n = d + 2 * kvd
    flat = torch.randn(B * T * n + offset, generator=g)
    flat *= torch.rand(B * T * n + offset, generator=g) * 4
    qkv = flat.to(dev, dtype)[offset:].reshape(B, T, n)
    return (qkv[..., d:d + kvd].reshape(B, T, KV, D),
            qkv[..., d + kvd:].reshape(B, T, KV, D))


def _prefill_planes(g, L, B, KV, S, D, cache):
    """Random (L, B, KV, S, D) caches of ``cache`` ('int8' with bf16
    planes, 'int8-f32' with f32 planes, 'bf16', 'f32') and their planes."""
    planes = _cache(g, (L, B, KV, S, D), cache.split("-")[0])
    if cache == "int8-f32":
        planes[2:] = [p.float() for p in planes[2:]]
    return planes


@pytest.mark.parametrize("T", [1, 17, 256, 1024])
@pytest.mark.parametrize("D", [64, 128, 36])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cache", ["int8", "int8-f32", "bf16", "f32"])
@pytest.mark.parametrize("heads", ["mha", "gqa", "unaligned"])
def test_kv_prefill_write_matches_plain(dev, T, D, dtype, cache, heads):
    """K10 over T rows (the prefill's KV write) against its plain version,
    bit for bit: the written cache rows and scale planes, the dequantized
    K/V of an int8 cache (else the cache views), and the rows past T
    untouched; K/V as strided slices of a fused qkv output, OPT's H = KV
    and 32/8 GQA, and rows 2- or 4-byte aligned (the narrower loads)."""
    from sleekit_tpu_torch.ops import attention as at

    g = torch.Generator().manual_seed(T + D)
    H, KV = {"mha": (8, 8), "gqa": (32, 8), "unaligned": (4, 2)}[heads]
    L, B, S = 2, 2, 1024
    k, v = _prefill_rows(g, dev, B, T, H, KV, D, dtype,
                         offset=1 if heads == "unaligned" else 0)
    assert not k.is_contiguous() or T == 1
    planes = _prefill_planes(g, L, B, KV, S, D, cache)
    got = [_on(dev, p) for p in planes]
    want = [None if p is None else p.clone() for p in planes]
    before = at.K10.launches
    got_kv = at.kv_prefill_write(k, v, got[0], got[1], 1, got[2], got[3])
    want_kv = at.kv_prefill_write_plain(k.cpu(), v.cpu(), want[0], want[1],
                                        1, want[2], want[3])
    torch.cuda.synchronize()
    assert at.K10.launches == before + 1
    for a, b in zip(got_kv, want_kv):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    for a, b in zip(got, want):
        if b is not None:
            assert torch.equal(a.cpu(), b)


def test_kv_prefill_write_replays_in_cuda_graph(dev):
    """The prefill write captured once in a CUDA graph, replayed on new
    K/V copied into its inputs, writes the eager call's cache rows, scales
    and dequantized K/V at every replay."""
    from sleekit_tpu_torch.ops import attention as at

    g = torch.Generator().manual_seed(11)
    L, B, T, H, KV, D = 2, 4, 256, 32, 32, 64
    k, v = _prefill_rows(g, dev, B, T, H, KV, D, torch.bfloat16)
    graph_c = [_on(dev, p) for p in _prefill_planes(g, L, B, KV, T, D,
                                                    "int8")]
    eager_c = [p.clone() for p in graph_c]

    def call(c):
        return at.kv_prefill_write(k, v, c[0], c[1], 1, c[2], c[3])

    call([p.clone() for p in graph_c])          # warm-up, on copies
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = at.K10.launches
    with torch.cuda.graph(graph):
        out = call(graph_c)
    assert at.K10.launches == before + 1
    for step in range(3):
        nk, nv = _prefill_rows(g, dev, B, T, H, KV, D, torch.bfloat16)
        k.copy_(nk)
        v.copy_(nv)
        graph.replay()
        want = call(eager_c)
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(a, b)
        for a, b in zip(graph_c, eager_c):
            assert torch.equal(a, b)


@pytest.mark.parametrize("G", _DECODE_G)
@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("edge", _EDGES)
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("D", _DECODE_D)
def test_flash_decode_matches_plain(dev, G, cache, edge, paged, D):
    """K11 (slot cache) and K15 (page pool) against their plain versions
    at the split edges and the head dims of ``_DECODE_D``: rows s <= pos,
    ALiBi, GQA; bf16 q within the bf16 tolerance, f32 q (f32 cache) within
    1e-5. The pool holds the slot cache's rows through a table of distinct
    pages out of order, so K15's output equals K11's bit for bit."""
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import paged_attention as pa

    g = torch.Generator().manual_seed(G + D)
    L, B, KV, PS, MAXP = 2, 6, 2, 64, 5
    S = PS * MAXP
    planes = _cache(g, (L, B, KV, S, D), cache)
    dt = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.randn(B, KV * G, D, generator=g).to(dt)
    pos = _edge_pos(edge, B, KV, G, D, planes[0].element_size(), S)
    slopes = torch.linspace(0.05, 0.9, KV * G)
    scale = 1 / math.sqrt(D)
    dplanes = [_on(dev, p) for p in planes]
    tpos = _on(dev, pos) if edge == "ragged" else pos
    k11 = at.flash_decode(q.to(dev), dplanes[0], dplanes[1], tpos, 1, scale,
                          slopes.to(dev), dplanes[2], dplanes[3])
    if paged:
        table = (1 + torch.randperm(B * MAXP, generator=g)).to(torch.int32)
        table = table.reshape(B, MAXP)
        pool = [_to_pool(p, table, PS) for p in planes]
        dpool = [_on(dev, p) for p in pool]
        before = pa.K15.launches
        got = pa.paged_flash_decode(q.to(dev), dpool[0], dpool[1],
                                    table.to(dev), tpos, 1, scale,
                                    slopes.to(dev), dpool[2], dpool[3])
        torch.cuda.synchronize()
        assert pa.K15.launches == before + 1
        assert torch.equal(got, k11)
        want = pa.paged_flash_decode_plain(q, pool[0], pool[1], table, pos,
                                           1, scale, slopes, pool[2],
                                           pool[3])
    else:
        got = k11
        want = at.flash_decode_plain(q, planes[0], planes[1], pos, 1, scale,
                                     slopes, planes[2], planes[3])
    torch.cuda.synchronize()
    if dt == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("cache", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("edge", _EDGES)
def test_k5_matches_plain_and_k3(dev, G, cache, edge):
    """K5 against its plain version (output within the bf16 tolerance,
    written bytes equal), and against K3 on the same logical rows: output
    and written bytes bit-identical, at the split edges."""
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import paged_attention as pa

    g = torch.Generator().manual_seed(10 + G)
    L, B, KV, D, PS, MAXP = 2, 6, 2, 64, 64, 5
    S = PS * MAXP
    slot = _cache(g, (L, B, KV, S, D), cache)
    dt = torch.float32 if cache == "f32" else torch.bfloat16
    q = torch.randn(B, KV * G, D, generator=g).to(dt)
    kn = torch.randn(B, KV, D, generator=g).to(dt)
    vn = torch.randn(B, KV, D, generator=g).to(dt)
    pos = _edge_pos(edge, B, KV, G, D, slot[0].element_size(), S)
    slopes = torch.linspace(0.05, 0.9, KV * G)
    scale = 1 / math.sqrt(D)
    # Row b's logical page j lives in physical page table[b, j], out of
    # order; page 0 stays unused.
    table = (1 + torch.randperm(B * MAXP, generator=g)).to(torch.int32)
    table = table.reshape(B, MAXP)
    pool = [_to_pool(x, table, PS) for x in slot]
    want = pa.paged_fused_decode_append_plain(
        q, kn, vn, *[None if p is None else p.clone() for p in pool[:2]],
        table, pos, 1, scale, slopes,
        *[None if p is None else p.clone() for p in pool[2:]])
    dpool = [_on(dev, p) for p in pool]
    dslot = [_on(dev, p) for p in slot]
    tpos = _on(dev, pos) if edge == "ragged" else pos
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
        assert torch.equal(a.cpu(), _to_pool(b.cpu(), table, PS))


@pytest.mark.parametrize("layout,K", [("pair3", 400), ("pair3", 1792),
                                      ("pair3x", 1536), ("pair3x", 3584)])
@pytest.mark.parametrize("pre", [None, "layernorm", "relu", "silu_glu"])
@pytest.mark.parametrize("m", [1, 8, 40, 1024])
@pytest.mark.parametrize("N", [200, 198, 1029])
def test_k6_k7_match_plain(dev, layout, K, pre, m, N):
    """K7 ('pair3', K not a multiple of its 256-row tile at 400) and K6
    ('pair3x'; at 3584 its 42 units of the streaming route do not divide
    into its 5 K splits) against their plain version, with a prologue and
    a residual, N not a multiple of the 32- or 64-column block (nor of 4,
    at 198 and 1029)."""
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
                                      "uniform3", "uniform4", "table1",
                                      "uniform1", "uniform2"])
@pytest.mark.parametrize("m", [1, 8, 9, 64, 1024])
@pytest.mark.parametrize("K,N", [(700, 200), (700, 198), (2048, 2052),
                                 (2048, 1030)])
def test_k8_k9_match_plain(dev, codebook, m, K, N):
    """K8 (tables: NF4, a k = 3 table at 2 bits, an unsorted 8-entry table
    at 3 bits, a 2-entry table at 1 bit; and the 8-bit affine grid) and K9
    (uniform 1-4 bits) on 'plane' words against their plain versions, on
    the streaming route (m <= 8) and the tensor-core route (m = 9 in 32 x
    64 tiles, 64 and 1024 in 128 x 128), with K (700) not a multiple of any
    plane tile and, at 3 bits, K = 2048 ending inside the last 320-row tile
    (OPT-1.3B's K); N not a multiple of the 32-column strip, nor of 4 at
    198 and 1030 (4-byte word loads)."""
    from sleekit_tpu_torch.codebooks import Codebook
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import bits_for_codebook, pack_indices

    g = torch.Generator().manual_seed(N + K)
    lut = {"nf4": Codebook.nf4().values,
           "table3": torch.tensor([-1.0, 0.1, 1.0]),
           "table8": torch.tensor([0.3, -1.0, 0.7, 0.05, -0.4, 1.0, -0.1,
                                   0.5]),
           "table1": torch.tensor([0.25, -0.5]),
           "affine8": torch.linspace(-1, 1, 256),
           "uniform1": torch.linspace(-1, 1, 2),
           "uniform2": torch.linspace(-1, 1, 4),
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


_PLANE_CODEBOOKS = ["nf4", "table3", "table8", "affine8", "uniform3",
                    "uniform4", "table1", "uniform1", "uniform2"]


def _plane_f32_call(dev, g, codebook, m, K, N, bias=True, positive=False):
    """(kernel, fn, plain, args, kw, x): K8f (tables: NF4, a k = 3 table at
    2 bits, an unsorted 8-entry table at 3 bits, a 2-entry table at 1 bit;
    the 8-bit affine grid) or K9f (uniform 1-4 bits) on random 'plane'
    words of a (K, N) matrix, with f32 x (m, K), |x| where ``positive``."""
    from sleekit_tpu_torch.codebooks import Codebook
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import bits_for_codebook, pack_indices

    lut = {"nf4": Codebook.nf4().values,
           "table3": torch.tensor([-1.0, 0.1, 1.0]),
           "table8": torch.tensor([0.3, -1.0, 0.7, 0.05, -0.4, 1.0, -0.1,
                                   0.5]),
           "table1": torch.tensor([0.25, -0.5]),
           "affine8": torch.linspace(-1, 1, 256),
           "uniform1": torch.linspace(-1, 1, 2),
           "uniform2": torch.linspace(-1, 1, 4),
           "uniform3": torch.linspace(-1, 1, 8),
           "uniform4": torch.linspace(-1, 1, 16)}[codebook]
    nbits = bits_for_codebook(lut.numel())
    packed = pack_indices(torch.randint(0, lut.numel(), (K, N), generator=g),
                          nbits, layout="plane").to(dev)
    x = torch.randn(m, K, generator=g).to(dev)
    if positive:
        x = x.abs()
    scale = torch.rand(N, generator=g).to(dev) + 0.5
    b = torch.randn(N, generator=g).to(dev) if bias else None
    if codebook.startswith("uniform"):
        kernel, fn, plain = dm.K9f, dm.plane_affine_matmul, \
            dm.plane_affine_matmul_plain
        step = 2.0 / (lut.numel() - 1)
        kw = dict(nbits=nbits, k=K, a_aff=step * 2 ** nbits,
                  b_aff=-1.0 - step * 2 ** nbits)
        args = (packed, scale, b)
    else:
        kernel, fn, plain = dm.K8f, dm.plane_lut_matmul, \
            dm.plane_lut_matmul_plain
        kw = dict(nbits=nbits, k=K,
                  affine=(2.0 / 255, -1.0) if codebook == "affine8" else None)
        args = (packed, scale, b, lut.to(dev))
    return kernel, fn, plain, args, kw, x


def _f32_close(got, ref):
    """Within 1e-5 of the largest |ref|: two f32-accurate sums of the same
    products in another order (K up to 8192 terms; the kernels' products
    split-TF32, each within about 2^-21 of the f32 product)."""
    assert got.dtype == ref.dtype == torch.float32
    err = (got - ref).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= 1e-5 * ref.abs().max().item(), err


def _exact_f32(x, args, kw):
    """What the plain versions of K8f/K9f compute (``args``, ``kw`` from
    _plane_f32_call), with the product (and K9f's row sums) taken exactly
    in f64 and rounded once to f32, the rest in f32 as they do it: the
    yardstick where an f32 product is itself off by more than 1e-5 (fc2's
    K = 8192 with x >= 0)."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import unpack_indices

    packed, scale, bias = args[:3]
    nbits = kw["nbits"]
    idx = unpack_indices(packed, nbits, kw["k"], layout="plane").long()
    xd = x.double()
    if len(args) == 4:
        table = dm._k8_table(args[3], nbits, kw["affine"], rounded=False)
        out = (xd @ table.to(x.device).double()[idx]).float() * scale
    else:
        c = idx.double() / 2 ** nbits - 0.5
        b_c = dm._centred(kw["a_aff"], kw["b_aff"], "plane")
        out = (kw["a_aff"] * (xd @ c).float()
               + b_c * xd.sum(dim=1, keepdim=True).float()) * scale
    return out if bias is None else out + bias


@pytest.mark.parametrize("codebook", _PLANE_CODEBOOKS)
@pytest.mark.parametrize("m,K,N", [
    (m, K, N) for K, N in [(700, 198), (2048, 2052)]
    for m in [1, 2, 3, 4, 5, 8, 9, 64, 520]] + [
        (m, 8192, 2048) for m in (2, 520)] + [
        (m, 8192, 256) for m in (2, 8)] + [(m, 700, 4498) for m in (2, 5)])
@pytest.mark.parametrize("bias", [True, False])
def test_k8f_k9f_match_plain(dev, codebook, m, K, N, bias):
    """K8f and K9f (f32 x) on 'plane' words against their plain versions
    (f32, the table unrounded, TF32 off), within 1e-5 of the largest
    output: on the streaming route (m <= 8: the tokens as mma.sync's n8,
    its columns past m zero, so 1-5 and 8 tokens, x's hi and lo sharing
    the n8 up to 4; 32-column strips, 141 at N = 4498, more than the
    SMs; K split over a cluster of blocks at K = 2048 but at 3 bits and
    at N = 256) and the tiled
    route (m = 9, 64, 520: split-TF32 in 128 x 128 tiles, K split over
    blocks where the tiles are fewer than the SMs), with K (700) not a
    multiple of any plane tile and, at 3 bits, K = 2048 ending inside the
    last 320-row tile; N not a multiple of a strip nor of 4 at 198 and
    4498 (4-byte word loads); fc2's shape (K 8192, N 2048) at m = 2 and
    520; with and without a bias. One counted launch a call."""
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator().manual_seed(N + K + m)
    kernel, fn, plain, args, kw, x = _plane_f32_call(dev, g, codebook, m, K,
                                                     N, bias)
    before = kernel.launches
    got = fn(x, *args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _f32_close(got, plain(x, *args, **kw))


@pytest.mark.parametrize("codebook", ["nf4", "affine8", "uniform4"])
@pytest.mark.parametrize("m", [2, 8, 520, 2048])
def test_k8f_k9f_nonnegative_x_long_k(dev, codebook, m):
    """K8f (NF4, the 8-bit affine grid) and K9f (uniform 4-bit) at fc2's
    shape (K 8192, N 2048) with x >= 0, as fc2's input is after the relu:
    sums that grow one way, where a bias in the accumulation would show,
    within 1e-5 of the largest output of the plain version's function
    with its product taken exactly (_exact_f32: the plain version's f32
    product is itself up to 1.4e-5 off there), on the streaming route (m
    = 2 and 8) and the tiled one (m = 520 with its K split, m = 2048)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    g = torch.Generator().manual_seed(m + len(codebook))
    kernel, fn, plain, args, kw, x = _plane_f32_call(
        dev, g, codebook, m, 8192, 2048, positive=True)
    before = kernel.launches
    got = fn(x, *args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _f32_close(got, _exact_f32(x, args, kw))


@pytest.mark.parametrize("codebook", ["nf4", "uniform4", "affine8"])
@pytest.mark.parametrize("m,N", [(2, 2048), (8, 2048), (2, 256), (64, 2048),
                                 (2048, 2048)])
def test_k8f_k9f_replay_in_cuda_graph(dev, codebook, m, N):
    """K8f and K9f captured in a CUDA graph at OPT-1.3B's fc2 shape (K
    8192, N 2048: at m <= 8 K split over a cluster of 2 blocks, summed
    through distributed shared memory; at m = 64 over blocks of the tiled
    route, the partials in a scratch allocated under capture, the tickets
    the device's; at m = 2048 the tiled route unsplit) and at N 256 (8
    strips, K split over a cluster of 8 blocks): two
    replays after x changes in place each equal the eager call for the
    new x, bit for bit, and an eager call equals a second one; the
    capture counts one launch."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm

    g = torch.Generator().manual_seed(m + N)
    K = 8192
    kernel, fn, _, args, kw, x = _plane_f32_call(dev, g, codebook, m, K, N)
    if m <= dm.DECODE_M:
        assert dm.f32_stream_plan(N, args[0].shape[0], kw["nbits"],
                                  dm._sms(0)) == {2048: (64, 2),
                                                  256: (8, 8)}[N]
    else:
        assert (dm.f32_tile_plan(m, N, K, dm._sms(0)) > 1) == (m == 64)
    first = fn(x, *args, **kw)
    assert torch.equal(first, fn(x, *args, **kw))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernel.launches
    with torch.cuda.graph(graph):
        out = fn(x, *args, **kw)
    assert kernel.launches == before + 1
    for _ in range(2):
        x.copy_(torch.randn(m, K, generator=g).to(dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fn(x, *args, **kw))


_MMA_PROBE = r"""
#include <cstdint>
// out[i] = C + sum_k A[k] * 1 over one m16n8k8 TF32 mma.sync, row 0 of
// the tile: c[i] the accumulator, p[8 i ..] the products (as A, B = 1).
__global__ void probe(const float* c, const float* p, float* out) {
  const int lane = threadIdx.x, gid = lane / 4, tig = lane % 4, i = blockIdx.x;
  const float* a = p + 8 * i;
  uint32_t r[4] = {__float_as_uint(gid ? 0.0f : a[tig]), 0u,
                   __float_as_uint(gid ? 0.0f : a[tig + 4]), 0u};
  const uint32_t b0 = __float_as_uint(gid ? 0.0f : 1.0f), b1 = b0;
  float d[4] = {lane ? 0.0f : c[i], 0.0f, 0.0f, 0.0f};
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]), "r"(b0), "r"(b1));
  if (lane == 0) out[i] = d[0];
}
extern "C" int mma_probe(const void* c, const void* p, void* out, int n) {
  probe<<<n, 32>>>(static_cast<const float*>(c), static_cast<const float*>(p),
                   static_cast<float*>(out));
  return (int)cudaDeviceSynchronize();
}
"""


def test_tf32_mma_truncates(dev, tmp_path):
    """The tensor cores' f32 sums, which both routes of K8f/K9f work
    around (a fresh fragment every TILE_CHAIN steps, or each unit of the
    streaming route), and K4's f32 route
    (a fresh P·V fragment a chunk): an m16n8k8 TF32 mma.sync aligns the
    accumulator and the products to the largest, truncates each 25 bits
    below it, and truncates the sum to f32 - no rounding to nearest (the
    model of tests/_torch_port_util.py tf32_mma)."""
    import ctypes
    import subprocess

    from sleekit_tpu_torch import kernels

    src = tmp_path / "mma_probe.cu"
    src.write_text(_MMA_PROBE)
    lib = tmp_path / "mma_probe.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).mma_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    u = 2.0 ** -23
    cases = [  # (c, products, the sum the tensor cores give)
        (1.0, [0.75 * u], 1.0),            # rounding to nearest: 1 + u
        (1.0, [u / 4] * 8, 1.0 + 2 * u),   # 2^-25 kept: exact
        (1.0, [u / 8] * 8, 1.0),           # 2^-26 dropped, each
        (1.0, [-0.625 * u], 1.0 - u / 2),  # truncated towards 0: -2^-24
        (0.0, [1.0, u / 4, u / 4], 1.0),   # the sum 1 + 2^-24 truncated
    ]
    c = torch.tensor([cs[0] for cs in cases], dtype=torch.float32, device=dev)
    p = torch.zeros(len(cases), 8, dtype=torch.float32)
    for i, (_, prods, _) in enumerate(cases):
        p[i, :len(prods)] = torch.tensor(prods, dtype=torch.float32)
    p = p.to(dev)
    out = torch.empty(len(cases), dtype=torch.float32, device=dev)
    assert fn(c.data_ptr(), p.data_ptr(), out.data_ptr(), len(cases)) == 0
    want = torch.tensor([cs[2] for cs in cases], dtype=torch.float32)
    assert torch.equal(out.cpu(), want), (out.cpu().tolist(), want.tolist())


def test_k8f_k9f_raise_without_scratch(dev):
    """A launch of K8f or K9f over K splits that no cluster holds (the
    streaming route at m = 4: 16 splits, or 3), over more than one split
    without the partials and tickets (the tiled route at m = 64), or at a
    width the kernels do not take (5 bits), returns a CUDA error that the
    binding raises."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm
    from sleekit_tpu_torch.ops.pack import pack_indices

    K, N = 512, 64
    scale = torch.ones(N, device=dev)
    lut = torch.linspace(-1, 1, 16, device=dev)
    packed = pack_indices(torch.zeros(K, N, dtype=torch.int64), 4,
                          layout="plane").to(dev)
    kw = packed.shape[0]
    for m, splits, nbits in ((4, 16, 4), (4, 3, 4), (4, 1, 5), (64, 2, 4),
                             (64, 1, 5)):
        x = torch.zeros(m, K, device=dev)
        out = torch.empty(m, N, device=dev)
        with pytest.raises(RuntimeError, match="CUDA error"):
            dm.K8f(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), 0,
                   lut.data_ptr(), out.data_ptr(), 0, 0, m, N, K, kw, splits,
                   nbits, 16, 0.0, 0.0)
        with pytest.raises(RuntimeError, match="CUDA error"):
            dm.K9f(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), 0,
                   out.data_ptr(), 0, 0, m, N, K, kw, splits, nbits, 1.0,
                   0.0)


def test_f32_plane_model_runs_k8f(dev, monkeypatch):
    """A small f32 model with NF4 'plane' linears on the card: its forward
    and decode_perplexity launch K8f for every linear (no K8, and
    dequant_matmul_ref never for a 'plane' linear), the decode graph
    equals the eager runner bit for bit, and the two perplexities agree
    within 1%."""
    from sleekit_tpu_torch import kernels
    from sleekit_tpu_torch.codebooks import Codebook
    from sleekit_tpu_torch.models import data, eval as ev
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.zoo import tiny_test
    from sleekit_tpu_torch.ops import dequant_matmul as dm

    ref = dm.dequant_matmul_ref

    def no_plane(x, w):
        assert w.layout != "plane", "a 'plane' linear took the plain route"
        return ref(x, w)

    monkeypatch.setattr(dm, "dequant_matmul_ref", no_plane)
    cfg = tiny_test(d_model=256, d_ff=512, n_heads=4, max_seq_len=256)
    params, _ = random_packed_params(cfg, 0, codebook=Codebook.nf4(),
                                     layout="plane", device=dev)
    stream = data.synthetic_stream(cfg.vocab_size, 4 * 64, seed=0)
    batches = list(ev.chunk_tokens(stream, 64, 2))
    kernels.reset_launch_counts()
    fwd = ev.perplexity(cfg, params, batches, device=dev)
    linears = 6 * cfg.n_layers
    assert dm.K8f.launches == linears * len(batches) and dm.K8.launches == 0
    graph = ev.decode_perplexity(cfg, params, batches, device=dev)
    eager = ev.decode_perplexity(cfg, params, batches, device=dev,
                                 graphs=False)
    assert graph == eager
    assert abs(graph - fwd) <= 0.01 * fwd, (graph, fwd)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("cache", ["int8", "bf16", "f32", "int8 f32 q"])
@pytest.mark.parametrize("edge", _EDGES)
def test_k12_k13_match_plain(dev, G, alibi, cache, edge):
    """K13 (batch fold; B = 10 rows over a block's groups) against its
    plain version (K11's) and K11 bit for bit; K12 (mha_mode='ew', G = 1)
    against its plain version, at the split edges. f32 q (over an f32 or
    int8 cache) within 1e-5; bf16 q: K13 within the bf16 tolerance, K12
    within one bf16 step (K12 and its plain version keep everything in f32
    and round only the output), a bound K11's bf16 numerics miss where
    more than one row is read."""
    from sleekit_tpu_torch.ops import attention as at

    g = torch.Generator().manual_seed(20 + G)
    L, B, KV, S, D = 2, 10, 2, 320, 64
    planes = _cache(g, (L, B, KV, S, D), cache.split()[0])
    dt = torch.bfloat16 if cache in ("int8", "bf16") else torch.float32
    q = torch.randn(B, KV * G, D, generator=g).to(dt)
    pos = _edge_pos(edge, B, KV, G, D, planes[0].element_size(), S)
    slopes = torch.linspace(0.05, 0.9, KV * G) if alibi else None
    scale = 1 / math.sqrt(D)
    dplanes = [_on(dev, p) for p in planes]
    tpos = _on(dev, pos) if edge == "ragged" else pos
    args = (q.to(dev), dplanes[0], dplanes[1], tpos, 1, scale,
            _on(dev, slopes), dplanes[2], dplanes[3])
    plain_args = (q, planes[0], planes[1], pos, 1, scale, slopes, planes[2],
                  planes[3])
    modes = [("bfold", at.K13, at.flash_decode_plain)]
    if G == 1:
        modes.append(("ew", at.K12, at.flash_decode_ew_plain))
    k11 = at.flash_decode(*args)
    for mode, kernel, plain in modes:
        before = kernel.launches
        got = at.flash_decode(*args, mha_mode=mode,
                              batch_fold=mode == "bfold")
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = plain(*plain_args)
        if dt == torch.float32:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        elif mode == "ew":
            assert _ulp_misses(got, want) == 0
            # At pos 0 one row is read: p = 1, and K11 is exact too.
            assert _ulp_misses(k11, want) > 0 or edge == "0"
        else:
            _bf16_close(got, want)
        if mode == "bfold":
            assert torch.equal(got, k11)


@pytest.mark.parametrize("mode", ["ew", "bfold"])
def test_k12_k13_replay_in_cuda_graph(dev, mode):
    """K12 and K13 launched through the split route's knobs are captured
    in a CUDA graph with a device pos, and a replay after pos changes in
    place gives the eager call's output at the new positions."""
    from sleekit_tpu_torch.ops import attention as at

    g = torch.Generator().manual_seed(7)
    L, B, KV, S, D = 2, 8, 4, 512, 64
    planes = [_on(dev, p) for p in _cache(g, (L, B, KV, S, D), "int8")]
    q = torch.randn(B, KV, D, generator=g).to(dev, torch.bfloat16)
    pos = torch.tensor([3, 100, 256, 511, 0, 40, 300, 129],
                       dtype=torch.int32, device=dev)
    kw = dict(mha_mode="ew") if mode == "ew" else dict(batch_fold=True)
    kernel = at.K12 if mode == "ew" else at.K13

    def call():
        return at.flash_decode(q, planes[0], planes[1], pos, 1, 0.125, None,
                               planes[2], planes[3], **kw)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernel.launches
    with torch.cuda.graph(graph):
        out = call()
    assert kernel.launches == before + 1
    pos.copy_(torch.tensor([511, 7, 64, 300, 128, 1, 0, 450],
                           dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())


@pytest.mark.parametrize("kernel", ["K3", "K5", "K11", "K13"])
def test_decode_attention_is_deterministic(dev, kernel):
    """Two launches on the same inputs give the same bits (output and, for
    K3 and K5, written bytes): the splits are combined in a fixed order,
    without float atomics, over many splits and ragged rows."""
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import paged_attention as pa

    g = torch.Generator().manual_seed(5)
    L, B, KV, G, D, PS, MAXP = 2, 8, 4, 1, 64, 64, 8
    S = PS * MAXP
    planes = _cache(g, (L, B, KV, S, D), "int8")
    q = torch.randn(B, KV * G, D, generator=g).to(dev, torch.bfloat16)
    kn = torch.randn(B, KV, D, generator=g).to(dev, torch.bfloat16)
    vn = torch.randn(B, KV, D, generator=g).to(dev, torch.bfloat16)
    pos = torch.tensor([511, 3, 300, 64, 0, 127, 450, 256],
                       dtype=torch.int32, device=dev)
    table = (1 + torch.randperm(B * MAXP, generator=g)).to(torch.int32)
    table = table.reshape(B, MAXP)
    if kernel == "K5":
        planes = [_to_pool(p, table, PS) for p in planes]
    planes = [_on(dev, p) for p in planes]
    dtable = table.to(dev)

    def call():
        c = [p.clone() for p in planes]
        if kernel == "K3":
            return at.fused_decode_append(q, kn, vn, c[0], c[1], pos, 1,
                                          0.125, None, c[2], c[3])
        if kernel == "K5":
            return pa.paged_fused_decode_append(q, kn, vn, c[0], c[1],
                                                dtable, pos, 1, 0.125, None,
                                                c[2], c[3])
        return (at.flash_decode(q, c[0], c[1], pos, 1, 0.125, None, c[2],
                                c[3], batch_fold=kernel == "K13"),)

    first, second = call(), call()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k3_replays_in_cuda_graph(dev):
    """K3 captured once in a CUDA graph with a device pos, replayed at
    successive positions across split edges, gives the eager calls' output
    and cache bytes at every step: the per-(row, head) tickets are back at
    0 after every launch, with no reset pass."""
    from sleekit_tpu_torch.ops import attention as at

    g = torch.Generator().manual_seed(9)
    L, B, KV, S, D = 2, 4, 2, 320, 64
    planes = _cache(g, (L, B, KV, S, D), "int8")
    q = torch.randn(B, KV, D, generator=g).to(dev, torch.bfloat16)
    kn = torch.randn(B, KV, D, generator=g).to(dev, torch.bfloat16)
    vn = torch.randn(B, KV, D, generator=g).to(dev, torch.bfloat16)
    start = torch.tensor([253, 126, 0, 61], dtype=torch.int32)
    graph_c = [_on(dev, p) for p in planes]
    eager_c = [p.clone() for p in graph_c]
    pos = start.to(dev)

    def call(c, p):
        return at.fused_decode_append(q, kn, vn, c[0], c[1], p, 1, 0.125,
                                      None, c[2], c[3])

    call([p.clone() for p in graph_c], pos)    # warm-up, on copies
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = at.K3.launches
    with torch.cuda.graph(graph):
        out = call(graph_c, pos)[0]
    assert at.K3.launches == before + 1
    for step in range(6):
        p = (start + step).to(dev)
        pos.copy_(p)
        graph.replay()
        want = call(eager_c, p)[0]
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        for a, b in zip(graph_c, eager_c):
            assert torch.equal(a, b)


def test_k13_grows_its_shared_memory(dev):
    """K13's block holds a group of 128 threads per batch row, up to the
    card's shared memory, so its bytes grow with B: in a fresh process, a
    call at B 2 (two groups, above the 48 KB default) then at B 8 (six)
    launches both, each equal to K11 bit for bit. The limit is raised
    again when a launch needs more than the last raise."""
    import subprocess
    import sys
    from pathlib import Path

    code = """
import torch
from sleekit_tpu_torch.ops import attention as at
dev = torch.device("cuda")
g = torch.Generator().manual_seed(4)
for B in (2, 8):
    k, ks = at._quant_rows(torch.randn(1, B, 2, 512, 64, generator=g))
    v, vs = at._quant_rows(torch.randn(1, B, 2, 512, 64, generator=g))
    args = [t.to(dev) for t in (k, v, ks[..., 0].bfloat16(),
                                 vs[..., 0].bfloat16())]
    q = torch.randn(B, 2, 64, generator=g).to(dev, torch.bfloat16)
    before = at.K13.launches
    got = at.flash_decode(q, args[0], args[1], 400, 0, 0.125, None,
                          args[2], args[3], batch_fold=True)
    want = at.flash_decode(q, args[0], args[1], 400, 0, 0.125, None,
                           args[2], args[3])
    torch.cuda.synchronize()
    assert at.K13.launches == before + 1
    assert torch.equal(got, want), B
print("ok")
"""
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr


def test_decode_attention_raises_without_scratch(dev):
    """A decode-attention launch without the plan's scratch and tickets,
    or with a split that is not decode_plan's, is refused: the entry
    returns an error and the wrapper raises."""
    from sleekit_tpu_torch.ops import attention as at

    B, KV, S, D = 2, 2, 128, 64
    q = torch.zeros(B, KV, D, device=dev, dtype=torch.bfloat16)
    cache = torch.zeros(1, B, KV, S, D, device=dev, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    R, splits, nbytes = at.decode_plan(B, KV, 1, D, 2, S)
    part = torch.empty(nbytes // 4, device=dev)
    tickets = torch.zeros(B * KV, dtype=torch.int32, device=dev)
    for p, t, r in ((0, tickets.data_ptr(), R), (part.data_ptr(), 0, R),
                    (part.data_ptr(), tickets.data_ptr(), R - 16)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            at.K11(q.data_ptr(), cache.data_ptr(), cache.data_ptr(), 0, 0, 0,
                   0, 0, out.data_ptr(), p, t, 7, 0, B, KV, 1, B, S, 1, D, r,
                   splits, 0.125, 1, 1, 0)


# ---- the decode loop as a replayed CUDA graph (models/eval.py DecodeGraph,
# the Engine's graph route) ---------------------------------------------------


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("G", [1, 4])
def test_k3_k5_vector_pos_equals_int_pos(dev, paged, G):
    """K3 (K5 over a pool) with a (B,) int32 pos holding one value in
    every row writes and returns, bit for bit, what it does with that int
    pos: the graph route always passes the vector."""
    from sleekit_tpu_torch.ops import attention as at
    from sleekit_tpu_torch.ops import paged_attention as pa

    g = torch.Generator().manual_seed(20 + G)
    L, B, KV, D, PS, MAXP = 2, 5, 2, 64, 64, 5
    slot = _cache(g, (L, B, KV, PS * MAXP, D), "int8")
    q = torch.randn(B, KV * G, D, generator=g).to(dev, torch.bfloat16)
    kn = torch.randn(B, KV, D, generator=g).to(dev, torch.bfloat16)
    vn = torch.randn(B, KV, D, generator=g).to(dev, torch.bfloat16)
    table = (1 + torch.randperm(B * MAXP, generator=g)).to(torch.int32)
    table = table.reshape(B, MAXP)
    for p in (0, 63, 64, 200, PS * MAXP - 1):
        outs = []
        for pos in (p, torch.full((B,), p, dtype=torch.int32, device=dev)):
            if paged:
                c = [_on(dev, _to_pool(x, table, PS)) for x in slot]
                out = pa.paged_fused_decode_append(
                    q, kn, vn, c[0], c[1], table.to(dev), pos, 1, 0.125,
                    None, c[2], c[3])[0]
            else:
                c = [_on(dev, x) for x in slot]
                out = at.fused_decode_append(q, kn, vn, c[0], c[1], pos, 1,
                                             0.125, None, c[2], c[3])[0]
            outs.append([out] + c)
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            assert torch.equal(a, b), p


def _tiny_int4(dev, **kw):
    """A small bf16 model with int4 'pair' linears (K1) and an int8 head
    (K2), random from seed 0."""
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.quantize import pack_lm_head
    from sleekit_tpu_torch.models.zoo import tiny_test

    cfg = tiny_test(d_model=256, d_ff=512, n_heads=4, max_seq_len=256,
                    dtype=torch.bfloat16, **kw)
    params, _ = random_packed_params(cfg, 0, fuse_qkv=True, layout="pair",
                                     device=dev)
    return cfg, pack_lm_head(cfg, params, nbits=8)


def _graph_specs(sampled=False):
    """Six requests for four slots (continuous batching, fused steps of
    uneven length), greedy; with ``sampled``, temperature 0.8, top-k 40
    and top-p 0.9 on four of them."""
    import numpy as np

    rng = np.random.RandomState(7)
    specs = []
    for i, (n, m) in enumerate([(5, 12), (19, 9), (40, 20), (3, 7),
                                (70, 11), (9, 16)]):
        kw = (dict(temperature=0.8, top_k=40, top_p=0.9)
              if sampled and i % 3 else {})
        specs.append((rng.randint(0, 256, n).astype(np.int32), m, kw))
    return specs


def _serve_tokens(cfg, params, dev, specs, **kw):
    from sleekit_tpu_torch.serve.engine import Engine, Request

    eng = Engine(cfg, params, max_slots=4, max_seq_len=128,
                 cache_dtype=torch.int8, seed=5, device=dev, **kw)
    comps = eng.run([Request(prompt=p.copy(), max_new_tokens=m, **s)
                     for p, m, s in specs])
    return eng, [c.tokens for c in comps]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sampled", [False, True])
def test_graph_engine_tokens_equal_eager(dev, paged, sampled):
    """The Engine on the graph route (the default on CUDA) emits the eager
    route's tokens (graphs=False), greedy and sampled from one seed, slot
    and paged, int8 cache: the same kernels on the same inputs in the same
    order, and the Engine's generator registered with the graph."""
    import numpy as np

    cfg, params = _tiny_int4(dev)
    specs = _graph_specs(sampled)
    kw = dict(paged=True, page_size=16) if paged else {}
    eng, graph = _serve_tokens(cfg, params, dev, specs, **kw)
    assert eng.graphs and sum(r.replays for r in eng.runners.values()) > 0
    assert ("topkp" in eng.runners) == sampled
    eager_eng, eager = _serve_tokens(cfg, params, dev, specs, graphs=False,
                                     **kw)
    assert not eager_eng.graphs
    _, again = _serve_tokens(cfg, params, dev, specs, **kw)
    for a, b, c in zip(graph, eager, again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_graph_launches_are_captured_times_replays(dev):
    """The runner's first call runs its step eagerly (counted launches)
    and captures it (no launches); each replay then counts the captured
    step's launches: 4 K1 and 1 K3 a layer, 1 K2."""
    from sleekit_tpu_torch import kernels
    from sleekit_tpu_torch.models.eval import DecodeGraph
    from sleekit_tpu_torch.models.transformer import init_kv_cache

    cfg, params = _tiny_int4(dev)
    cache = init_kv_cache(cfg, 4, 64, torch.int8, device=dev)
    run = DecodeGraph(cfg, params, 4, 8, device=dev)
    run.pos.fill_(3)
    want = {"K1": 4 * cfg.n_layers, "K2": 1, "K3": cfg.n_layers}

    def counts():
        return {k.name: k.launches for k in kernels.KERNELS if k.launches}

    kernels.reset_launch_counts()
    run.run(cache, 1)
    torch.cuda.synchronize()
    assert counts() == want and run.replays == 0
    assert {k.name: n for k, n in run.captured.items()} == want
    kernels.reset_launch_counts()
    run.run(cache, 6)
    torch.cuda.synchronize()
    assert counts() == {k: 6 * n for k, n in want.items()}
    assert run.replays == 6


def test_capture_runs_without_the_collector(dev, monkeypatch):
    """Python's collector is off while a runner captures its step, and on
    again after: a collection inside the capture could destroy an
    unreachable runner's graph, which invalidates the capture (chip_smoke's
    quantize phase hit it serving a second model: CUDA error 901 at K1's
    launch inside the capture)."""
    import gc

    from sleekit_tpu_torch.models.eval import DecodeGraph
    from sleekit_tpu_torch.models.transformer import init_kv_cache

    cfg, params = _tiny_int4(dev)
    cache = init_kv_cache(cfg, 4, 64, torch.int8, device=dev)
    states = []
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(graph, *a, **kw):
        states.append(gc.isenabled())
        begin(graph, *a, **kw)

    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin", capture_begin)
    assert gc.isenabled()
    run = DecodeGraph(cfg, params, 4, 8, device=dev)
    run.pos.fill_(3)
    run.run(cache, 4)
    torch.cuda.synchronize()
    assert states == [False] and gc.isenabled()
    assert run.captures == 1 and run.replays == 3


def _runner_tokens(cfg, params, dev, graphs, steps=6, cache=None):
    from sleekit_tpu_torch.models.eval import DecodeGraph
    from sleekit_tpu_torch.models.transformer import init_kv_cache, prefill

    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, 256, (3, 20), generator=g).to(dev)
    if cache is None:
        cache = init_kv_cache(cfg, 3, 64, torch.int8, device=dev)
    logits, _ = prefill(cfg, params, prompt, cache)
    run = DecodeGraph(cfg, params, 3, steps, device=dev, graphs=graphs)
    run.last.copy_(logits[:, -1].argmax(-1))
    run.pos.fill_(20)
    run.run(cache, steps)
    torch.cuda.synchronize()
    return run, cache


@pytest.mark.parametrize("family", ["bloom", "llama"])
def test_alibi_and_rope_steps_capture(dev, family):
    """A BLOOM step (ALiBi slopes, held on the device) and a Llama step
    (RoPE, GQA, SwiGLU) capture and replay: the graph's tokens and cache
    equal the eager runner's."""
    geo = {"bloom": dict(activation="gelu", positional="alibi",
                         embed_ln=True),
           "llama": dict(activation="silu_glu", norm="rmsnorm",
                         positional="rope", n_kv_heads=2,
                         tie_embeddings=False)}[family]
    cfg, params = _tiny_int4(dev, **geo)
    run, cache = _runner_tokens(cfg, params, dev, True)
    assert run.graph is not None and run.replays == 5
    eager, eager_cache = _runner_tokens(cfg, params, dev, False)
    assert torch.equal(run.tokens, eager.tokens)
    for k in cache:
        assert torch.equal(cache[k], eager_cache[k]), k


def test_changed_route_knob_or_cache_captures_again(dev, monkeypatch):
    """The graph freezes the route knobs and the cache's addresses, as
    JAX's trace does: turning FLASH_FUSED_APPEND off, or a new cache,
    captures again (the split route: K10 + K11 a layer, no K3)."""
    from sleekit_tpu_torch.models.transformer import init_kv_cache
    from sleekit_tpu_torch.ops import attention

    cfg, params = _tiny_int4(dev)
    run, cache = _runner_tokens(cfg, params, dev, True)
    fused = run.graph
    assert {k.name for k in run.captured} == {"K1", "K2", "K3"}
    monkeypatch.setattr(attention, "FLASH_FUSED_APPEND", False)
    run.last.zero_()
    run.run(cache, 3)
    assert run.graph is not fused
    assert {k.name for k in run.captured} == {"K1", "K2", "K10", "K11"}
    split = run.graph
    run.run(cache, 2)
    assert run.graph is split
    run.run(init_kv_cache(cfg, 3, 64, torch.int8, device=dev), 2)
    assert run.graph is not split


def test_decode_perplexity_graph_equals_eager(dev):
    """decode_perplexity through the graph equals the eager runner's, bit
    for bit (f32 cache, JAX's default), and the forward perplexity within
    1% (the two routes round bf16 activations in other places)."""
    from sleekit_tpu_torch.models import data, eval as ev

    cfg, params = _tiny_int4(dev)
    stream = data.synthetic_stream(cfg.vocab_size, 4 * 64, seed=0)
    batches = list(ev.chunk_tokens(stream, 64, 2))
    graph = ev.decode_perplexity(cfg, params, batches, device=dev)
    eager = ev.decode_perplexity(cfg, params, batches, device=dev,
                                 graphs=False)
    fwd = ev.perplexity(cfg, params, batches, device=dev)
    assert graph == eager
    assert abs(graph - fwd) <= 0.01 * fwd, (graph, fwd)


def test_quantize_layer_card_matches_cpu(dev):
    """quantize_layer (light, 4 bits) on a 512 x 1024 layer on the card
    against the port on the CPU, from the same tensors: the objective
    within 1e-3 relative and at least 99% of Q's codewords equal (the
    card's f32 products, Cholesky and triangular solve round in other
    places, which can flip a rounding decision that the sweep then
    carries)."""
    import numpy as np
    from sleekit_tpu_torch.pipeline import preset_config, quantize_layer

    rng = np.random.default_rng(0)
    W = torch.from_numpy(rng.standard_normal((512, 1024)).astype(np.float32)
                         * 0.02)
    X = torch.from_numpy((rng.standard_normal((4096, 1024)) + 0.1).astype(
        np.float32))
    H, mean = X.T @ X / 4096, X.mean(0)
    cfg = preset_config("light", nbits=4)
    cpu = quantize_layer(W, H, mean, cfg)
    card = [t.cpu() for t in quantize_layer(W.to(dev), H.to(dev),
                                            mean.to(dev), cfg)]
    assert all(torch.isfinite(t).all() for t in card)
    err_cpu, err_card = float(cpu[3].sum()), float(card[3].sum())
    assert abs(err_card - err_cpu) <= 1e-3 * err_cpu, (err_card, err_cpu)
    cb = cfg.make_codebook()
    same = (cb.quantize_index(cpu[0] / cpu[2][:, None])
            == cb.quantize_index(card[0] / card[2][:, None]))
    assert same.float().mean() >= 0.99


def test_batched_quantize_layer_card_matches_serial(dev):
    """quantize_layer (light, 4 bits) over a stack of three 256 x 512
    layers on the card against each layer's serial solve on the card:
    every error within 2e-3 relative and at least 95% of the codewords
    equal, chip_smoke's bounds (the order's column sums over L lanes,
    cuSOLVER's batched Cholesky and cuBLAS's batched products round in
    other places than the single calls, and the sweep carries a flipped
    decision along its row)."""
    import numpy as np
    from sleekit_tpu_torch.pipeline import preset_config, quantize_layer

    rng = np.random.default_rng(1)
    W = torch.from_numpy(rng.standard_normal((3, 256, 512)).astype(
        np.float32) * 0.02).to(dev)
    X = torch.from_numpy((rng.standard_normal((3, 2048, 512)) + 0.1).astype(
        np.float32)).to(dev)
    H, mean = X.transpose(1, 2) @ X / 2048, X.mean(1)
    cfg = preset_config("light", nbits=4)
    cb = cfg.make_codebook()
    batched = quantize_layer(W, H, mean, cfg)
    assert all(torch.isfinite(t).all() for t in batched)
    for i in range(3):
        serial = quantize_layer(W[i], H[i], mean[i], cfg)
        e_b, e_s = float(batched[3][i].sum()), float(serial[3].sum())
        assert abs(e_b - e_s) <= 2e-3 * e_s, (i, e_b, e_s)
        same = (cb.quantize_index(batched[0][i] / batched[2][i, :, None])
                == cb.quantize_index(serial[0] / serial[2][:, None]))
        assert same.float().mean() >= 0.95, i


def _write_safetensors(path, tensors):
    """A safetensors file written by hand (the card's machine has no
    ``safetensors`` package): the 8-byte little-endian header length, the
    JSON header, then the raw little-endian buffers."""
    import json

    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def test_hf_reader_and_convert_opt_on_the_card(dev, tmp_path):
    """A tiny OPT state dict written as F16 safetensors (and a BF16
    tensor beside it) read back by the port's parser as f32, bit for bit,
    and converted onto the card: (in, out) kernels equal to the state
    dict's transposed weights."""
    import numpy as np
    from sleekit_tpu_torch.models.hf import load_hf_checkpoint, load_state_dict
    from sleekit_tpu_torch.models.zoo import tiny_test

    cfg = tiny_test(n_layers=1)
    g = torch.Generator().manual_seed(0)
    d, ff, pre = cfg.d_model, cfg.d_ff, "model.decoder."
    shapes = {pre + "embed_tokens.weight": (cfg.vocab_size, d),
              pre + "embed_positions.weight": (cfg.max_seq_len + 2, d),
              pre + "final_layer_norm.weight": (d,),
              pre + "final_layer_norm.bias": (d,)}
    lp = pre + "layers.0."
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        shapes[f"{lp}self_attn.{n}.weight"] = (d, d)
        shapes[f"{lp}self_attn.{n}.bias"] = (d,)
    for n in ("self_attn_layer_norm", "final_layer_norm"):
        shapes[f"{lp}{n}.weight"] = (d,)
        shapes[f"{lp}{n}.bias"] = (d,)
    shapes.update({lp + "fc1.weight": (ff, d), lp + "fc1.bias": (ff,),
                   lp + "fc2.weight": (d, ff), lp + "fc2.bias": (d,)})
    sd = {k: torch.randn(*s, generator=g).to(torch.float16)
          for k, s in shapes.items()}
    _write_safetensors(tmp_path / "model.safetensors", sd)
    xb = torch.randn(3, 5, generator=g).bfloat16()
    _write_safetensors(tmp_path / "extra.safetensors", {"x": xb})
    got = load_state_dict(str(tmp_path / "model.safetensors"))
    for k, t in sd.items():
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], t.float().numpy()), k
    x = load_state_dict(str(tmp_path / "extra.safetensors"))["x"]
    assert np.array_equal(x, xb.float().numpy())
    params = load_hf_checkpoint(cfg, "opt-tiny", str(tmp_path), device=dev)
    q = params["layers"][0]["attn"]["q"]["kernel"]
    assert q.device.type == dev.type and q.is_contiguous()
    assert torch.equal(q.cpu(), sd[lp + "self_attn.q_proj.weight"].float().T)
    assert torch.equal(params["embed"]["pos"].cpu(),
                       sd[pre + "embed_positions.weight"].float())


def test_sleekit_on_a_cuda_layer_matches_the_cpu(dev):
    """The torch-facing ``Sleekit`` on a CUDA ``nn.Linear``: statistics on
    the card, within 1e-5 of the same layer's on the CPU; quantized in
    place on the card (basic, 4 bits) with the objective of the CPU's
    within 1e-3 and at least 99% of the weights equal."""
    import copy

    import torch.nn as nn
    from sleekit_tpu_torch import Sleekit

    torch.manual_seed(0)
    cpu_layer = nn.Linear(256, 128)
    card_layer = copy.deepcopy(cpu_layer).to(dev)
    a, b = Sleekit(cpu_layer), Sleekit(card_layer)
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        x = torch.randn(64, 256, generator=g) + 0.1
        a.add_batch(x)
        b.add_batch(x.to(dev))
    assert b.hessian.device.type == dev.type and a.count == b.count == 192
    torch.testing.assert_close(b.hessian.cpu(), a.hessian, rtol=1e-5,
                               atol=1e-5 * a.hessian.abs().max().item())
    H = a.hessian.clone()
    W = cpu_layer.weight.detach().clone()
    a.quantize_basic(4)
    b.quantize_basic(4)
    assert card_layer.weight.device.type == dev.type
    Qa, Qb = cpu_layer.weight.detach(), card_layer.weight.detach().cpu()

    def objective(Q):
        E = W - Q
        return float(((E @ H) * E).sum())

    assert abs(objective(Qb) - objective(Qa)) <= 1e-3 * objective(Qa)
    assert (Qa == Qb).float().mean() >= 0.99


def test_calibrate_spill_on_the_card(dev):
    """Layer-outer calibration on the card (K4 at T 256 in f32): host
    statistics in page-locked memory, equal to ``calibrate``'s on the
    card, bit for bit."""
    import numpy as np
    from sleekit_tpu_torch.models import quantize as tq
    from sleekit_tpu_torch.models.transformer import init_params
    from sleekit_tpu_torch.models.zoo import tiny_test

    cfg = tiny_test(n_layers=3, max_seq_len=256)
    params = init_params(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int32)
               for _ in range(2)]
    got = tq.calibrate_spill(cfg, params, batches)
    want = tq.calibrate(cfg, params, batches)
    assert list(got) == list(want)
    for name, st in got.items():
        for f in ("mean", "hessian", "count"):
            x = getattr(st, f)
            assert x.device.type == "cpu" and x.is_pinned()
            assert torch.equal(x, getattr(want[name], f).cpu()), (name, f)


def test_tp_world1_nccl_step_in_a_graph_equals_eager(dev, tmp_path):
    """``tp_decode_step`` over a world-1 NCCL group (tiny bf16 int4 model,
    int8 head and KV): captured in a CUDA graph with its two all-reduces a
    layer, its replay's logits and cache equal the eager step's, bit for
    bit; ``DecodeGraph`` over the mesh captures the same step (the
    all-reduces counted at each replay) and emits its eager route's
    tokens."""
    import torch.distributed as dist

    from sleekit_tpu_torch import kernels
    from sleekit_tpu_torch.models.eval import DecodeGraph
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.quantize import pack_lm_head
    from sleekit_tpu_torch.models.transformer import init_kv_cache, prefill
    from sleekit_tpu_torch.models.zoo import tiny_test
    from sleekit_tpu_torch.parallel.distributed import init_process_group
    from sleekit_tpu_torch.parallel.mesh import make_mesh, shard_params
    from sleekit_tpu_torch.parallel.tp_decode import tp_decode_step

    init_process_group(init_method=f"file://{tmp_path}/rendezvous", rank=0,
                       world_size=1, device=dev)
    try:
        mesh = make_mesh(model=1)
        assert mesh.group.backend == "nccl" and mesh.group.capturable
        cfg = tiny_test(d_model=512, d_ff=1024, n_heads=8, max_seq_len=512,
                        dtype=torch.bfloat16)
        params, _ = random_packed_params(cfg, 0, device=dev)
        params = shard_params(cfg, pack_lm_head(cfg, params), mesh)
        cache = init_kv_cache(cfg, 4, 64, torch.int8, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (4, 16), device=dev,
                             generator=torch.Generator(dev).manual_seed(0))
        logits, _ = prefill(cfg, params, toks, cache)
        nxt = logits[:, -1].argmax(-1)[:, None]
        pos = torch.full((4,), 16, dtype=torch.int32, device=dev)
        eager_cache = {k: v.clone() for k, v in cache.items()}
        graph_cache = {k: v.clone() for k, v in cache.items()}
        eager, _ = tp_decode_step(cfg, params, nxt, eager_cache, pos, mesh)
        g = torch.cuda.CUDAGraph()
        mesh.group.reset_counts()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            out, _ = tp_decode_step(cfg, params, nxt, graph_cache, pos, mesh)
        assert mesh.group.counts == {"all_reduce": 2 * cfg.n_layers,
                                     "all_gather": 0}
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        for k in cache:
            assert torch.equal(graph_cache[k], eager_cache[k]), k

        tokens = {}
        for graphs in (False, True):
            run = DecodeGraph(cfg, params, 4, 6, device=dev, graphs=graphs,
                              mesh=mesh)
            run.last.copy_(nxt[:, 0])
            run.pos.copy_(pos)
            mesh.group.reset_counts()
            kernels.reset_launch_counts()
            run.run({k: v.clone() for k, v in cache.items()}, 6)
            tokens[graphs] = run.tokens.clone()
            assert mesh.group.counts["all_reduce"] == 6 * 2 * cfg.n_layers
        assert run.replays == 5
        assert torch.equal(tokens[True], tokens[False])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("paged", [False, True])
def test_two_replicas_on_one_card_match_standalone(dev, paged):
    """A ``ReplicaRouter`` over ``replica_meshes(2, devices=["cuda:0",
    "cuda:0"])``: two single-device Engines on the graph route, request i
    on replica i % 2, each replica's tokens (greedy and sampled) those of
    a standalone Engine of the same geometry and seed fed its requests,
    slot and paged."""
    from sleekit_tpu_torch.serve.engine import Request
    from sleekit_tpu_torch.serve.router import ReplicaRouter, replica_meshes

    cfg, params = _tiny_int4(dev)
    specs = _graph_specs(sampled=True)
    kw = dict(paged=True, page_size=16) if paged else {}
    meshes = replica_meshes(2, devices=["cuda:0", "cuda:0"])
    router = ReplicaRouter(cfg, params, meshes, max_slots=4, max_seq_len=128,
                           cache_dtype=torch.int8, seed=5, **kw)
    assert all(e.graphs and e.device == torch.device("cuda", 0)
               for e in router.engines.values())
    comps = router.run([Request(prompt=p.copy(), max_new_tokens=m, **s)
                        for p, m, s in specs])
    assert [router.owner(c.request_id) for c in comps] == [0, 1] * 3
    for rep in (0, 1):
        _, want = _serve_tokens(cfg, params, dev, specs[rep::2], **kw)
        for c, w in zip(comps[rep::2], want):
            assert (c.tokens == w).all(), c.request_id


def test_finalize_psum_stages_cuda_stats_through_gloo(dev, tmp_path):
    """``finalize_psum`` over a world-1 gloo group on CUDA statistics: the
    all-reduces go through the host (gloo's staging) and the merged
    statistics come back on the card, equal to the rank's own (a world of
    one: weight 1); a zero count gives zero weights, not NaN."""
    import torch.distributed as dist

    from sleekit_tpu_torch.hessian import (
        LayerStats, finalize_psum, init_stats, update_stats)
    from sleekit_tpu_torch.parallel.distributed import (
        TPGroup, init_process_group)

    init_process_group(backend="gloo",
                       init_method=f"file://{tmp_path}/rendezvous", rank=0,
                       world_size=1, device=dev)
    try:
        group = TPGroup()
        x = torch.randn(40, 32, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        st = update_stats(init_stats(32, device=dev), x)
        got = finalize_psum(st, group)
        assert group.counts == {"all_reduce": 3, "all_gather": 0}
        assert got.hessian.is_cuda and got.mean.is_cuda
        assert torch.equal(got.count, st.count)
        assert torch.equal(got.hessian, st.hessian)
        assert torch.equal(got.mean, st.mean)
        empty = finalize_psum(init_stats(32, device=dev), group)
        assert float(empty.count) == 0.0
        assert torch.isfinite(empty.hessian).all()
        assert isinstance(empty, LayerStats)
    finally:
        dist.destroy_process_group()
