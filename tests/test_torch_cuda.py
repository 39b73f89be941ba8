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
