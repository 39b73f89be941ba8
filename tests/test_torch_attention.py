"""Kernels K3 (fused append + flash decode) and K4 (causal flash prefill)
of the port: their plain versions, which the wrappers take for CPU
tensors, against the JAX Pallas kernels in interpret mode; the port's
oracle against the XLA oracle (mirrors tests/test_attention.py:386,484,518,
563)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.ops import attention as jattn
from sleekit_tpu_torch.ops import attention as tattn

from tests._torch_port_util import bf16_close, f32, t


def _setup(G, quant, dtype, L=3, B=4, KV=2, S=32, D=64, seed=0,
           scale_dtype=np.float32):
    rng = np.random.RandomState(seed)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    if quant:
        # An int8 cache as serving fills it: quantized N(0, 1) rows.
        sdt = jnp.bfloat16 if scale_dtype == "bf16" else jnp.float32
        ck, ks = jattn._quant_rows(jnp.asarray(rng.randn(L, B, KV, S, D),
                                               jnp.float32))
        cv, vs = jattn._quant_rows(jnp.asarray(rng.randn(L, B, KV, S, D),
                                               jnp.float32))
        ck, cv = np.asarray(ck), np.asarray(cv)
        ks = np.asarray(ks[..., 0].astype(sdt))
        vs = np.asarray(vs[..., 0].astype(sdt))
    else:
        ck = np.asarray(jnp.asarray(rng.randn(L, B, KV, S, D), jdt))
        cv = np.asarray(jnp.asarray(rng.randn(L, B, KV, S, D), jdt))
        ks = vs = None
    kn = np.asarray(jnp.asarray(rng.randn(B, KV, D), jdt))
    vn = np.asarray(jnp.asarray(rng.randn(B, KV, D), jdt))
    q = np.asarray(jnp.asarray(rng.randn(B, KV * G, D), jdt))
    return ck, cv, ks, vs, kn, vn, q


def _torch(*arrays):
    return [None if a is None else t(a) for a in arrays]


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("cache", ["int8", "bf16"])
@pytest.mark.parametrize("pos_kind", ["scalar", "ragged"])
def test_fused_decode_append_plain_matches_jax_kernel(G, alibi, cache,
                                                      pos_kind):
    """K3's plain version == fused_decode_append_pallas (interpret): the
    written int8 cache bytes and bf16 scales are bit-identical (bf16 cache
    rows too), the output within 2e-2 in bf16 (p is rounded to bf16
    before p @ V at different running maxima)."""
    quant = cache == "int8"
    ck, cv, ks, vs, kn, vn, q = _setup(G, quant, "bf16", seed=G,
                                       scale_dtype="bf16")
    S = ck.shape[3]
    pos = (np.int32(17) if pos_kind == "scalar"
           else np.asarray([0, S - 1, 40, S // 2], np.int32))
    layer = 1
    H = q.shape[1]
    slopes = np.linspace(0.05, 0.9, H).astype(np.float32) if alibi else None
    scale = 1.0 / np.sqrt(ck.shape[-1])
    want = jattn.fused_decode_append_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pos), jnp.int32(layer), scale,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), block_s=16,
        interpret=True)
    tpos = int(pos) if pos_kind == "scalar" else torch.from_numpy(pos)
    targs = _torch(ck, cv, ks, vs)
    got = tattn.fused_decode_append(
        t(q), t(kn), t(vn), targs[0], targs[1], tpos, layer, scale,
        alibi_slopes=None if slopes is None else t(slopes),
        k_scale=targs[2], v_scale=targs[3])
    assert len(got) == len(want)
    assert got[1] is targs[0]  # caches are updated in place
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), rtol=2e-2,
                               atol=2e-2)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(f32(g), f32(w))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_fused_decode_append_plain_f32(G, alibi, quant):
    """f32 q with f32 caches (and int8 caches with f32 scales): output
    within 1e-5 of the JAX kernel, written rows bit-identical; positions
    at 0, S-1 and beyond S-1 (clamped)."""
    ck, cv, ks, vs, kn, vn, q = _setup(G, quant, "f32", seed=10 + G)
    S = ck.shape[3]
    pos = np.asarray([0, S - 1, S + 5, 9], np.int32)
    H = q.shape[1]
    slopes = np.linspace(0.05, 0.9, H).astype(np.float32) if alibi else None
    scale = 1.0 / np.sqrt(ck.shape[-1])
    want = jattn.fused_decode_append_pallas(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pos), jnp.int32(2), scale,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), interpret=True)
    targs = _torch(ck, cv, ks, vs)
    got = tattn.fused_decode_append(
        t(q), t(kn), t(vn), targs[0], targs[1], torch.from_numpy(pos), 2,
        scale, alibi_slopes=None if slopes is None else t(slopes),
        k_scale=targs[2], v_scale=targs[3])
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(f32(g), f32(w))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("alibi", [False, True])
def test_decode_attention_oracle_matches_xla(quant, alibi):
    """The port's oracle (kv_append_ref + flash_decode_ref) ==
    kv_append_xla + flash_decode_xla, f32; decode_attention's plain route
    (K3's plain version) agrees within 1e-5."""
    ck, cv, ks, vs, kn, vn, q = _setup(3, quant, "f32", seed=5)
    pos = np.asarray([3, 31, 0, 12], np.int32)
    slopes = (np.linspace(0.05, 0.9, q.shape[1]).astype(np.float32)
              if alibi else None)
    jslopes = None if slopes is None else jnp.asarray(slopes)
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pos), jnp.int32(0), alibi_slopes=jslopes,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), use_pallas=False)
    targs = _torch(ck, cv, ks, vs)
    tslopes = None if slopes is None else t(slopes)
    tpos = torch.from_numpy(pos)
    ref = [None if a is None else a.clone() for a in targs]
    upd = tattn.kv_append_ref(t(kn), t(vn), ref[0], ref[1], tpos, 0,
                              k_scale=ref[2], v_scale=ref[3])
    out = tattn.flash_decode_ref(t(q), upd[0], upd[1], tpos, 0,
                                 1.0 / np.sqrt(ck.shape[-1]), tslopes,
                                 *(upd[2:] if quant else (None, None)))
    np.testing.assert_allclose(f32(out), f32(want[0]), rtol=1e-5, atol=1e-5)
    for g, w in zip(upd, want[1:]):
        np.testing.assert_array_equal(f32(g), f32(w))
    got = tattn.decode_attention(
        t(q), t(kn), t(vn), targs[0], targs[1], tpos, 0,
        alibi_slopes=tslopes, k_scale=targs[2], v_scale=targs[3],
        use_kernel=False)
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(f32(g), f32(w))


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_prefill_plain_matches_jax_kernel(G, alibi, dtype):
    """K4's plain version == flash_prefill_pallas (interpret): 1e-5 in f32,
    2e-2 in bf16 (p rounded to bf16 at different running maxima)."""
    rng = np.random.RandomState(17 + G)
    B, KV, T, D = 1, 2, 256, 32
    H = KV * G
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q = np.asarray(jnp.asarray(rng.randn(B, T, H, D), jdt))
    k = np.asarray(jnp.asarray(rng.randn(B, KV, T, D), jdt))
    v = np.asarray(jnp.asarray(rng.randn(B, KV, T, D), jdt))
    slopes = np.linspace(0.02, 0.4, H).astype(np.float32) if alibi else None
    scale = 1.0 / np.sqrt(D)
    want = jattn.flash_prefill_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        t_blk=128, s_chunk=128, interpret=True)
    got = tattn.flash_prefill(t(q), t(k), t(v), scale,
                              None if slopes is None else t(slopes))
    assert got.shape == (B, T, H, D) and got.dtype == t(q).dtype
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_quant_rows_bit_identical():
    """The int8 KV quantizer rounds half to even and divides by its scale,
    byte for byte as the JAX package does (ties included)."""
    rng = np.random.RandomState(2)
    x = rng.randn(64, 64).astype(np.float32)
    x[:, 0] = 127.0          # scale exactly 1: x/scale = x
    x[:8, 1:9] = np.arange(8) + 0.5   # exact .5 ties
    jq, js = jattn._quant_rows(jnp.asarray(x))
    tq, ts = tattn._quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---- the split route: K10 append and K11 flash decode -----------------------


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "int8-f32-scales"])
@pytest.mark.parametrize("pos_kind", ["scalar", "ragged"])
def test_kv_append_plain_matches_jax_kernel(cache, pos_kind):
    """K10's plain version (the wrapper on CPU tensors) writes the bytes of
    kv_append_pallas (interpret): the uniform path for a scalar pos, the
    per-row grid for a ragged one, clamped beyond S-1; with f32 scale
    planes, those of the XLA oracle (mirrors
    tests/test_attention.py:32,249,360)."""
    quant = cache.startswith("int8")
    sdt = "f32" if cache == "int8-f32-scales" else "bf16"
    ck, cv, ks, vs, kn, vn, _ = _setup(1, quant, "bf16" if cache == "bf16"
                                       else "f32", seed=3, scale_dtype=sdt)
    S = ck.shape[3]
    pos = (np.int32(13) if pos_kind == "scalar"
           else np.asarray([0, S - 1, S + 4, 21], np.int32))
    jargs = (jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck),
             jnp.asarray(cv), jnp.asarray(pos), jnp.int32(1))
    jscales = dict(k_scale=None if ks is None else jnp.asarray(ks),
                   v_scale=None if vs is None else jnp.asarray(vs))
    if cache == "int8-f32-scales":
        # Jitted on the CPU, XLA turns the kernel's max|x| / 127 into a
        # product with 1/127, one f32 step off the division in some rows
        # (ROADMAP queue 3); the division is the XLA oracle's, run op by
        # op, and the port's.
        want = jattn.kv_append_xla(*jargs, **jscales)
    else:
        want = jattn.kv_append_pallas(*jargs, **jscales, interpret=True)
    targs = _torch(ck, cv, ks, vs)
    got = tattn.kv_append(t(kn), t(vn), targs[0], targs[1],
                          int(pos) if pos_kind == "scalar"
                          else torch.from_numpy(pos), 1,
                          k_scale=targs[2], v_scale=targs[3])
    assert len(got) == len(want) and got[0] is targs[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(f32(g), f32(w))


@pytest.mark.parametrize("dtype,G", [("f32", 1), ("f32", 4), ("bf16", 4)])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_plain_matches_jax_kernel(G, alibi, quant, dtype):
    """K11's plain version == flash_decode_pallas (interpret) over s <= pos
    with multi-block online softmax (block_s 16) and a chunked KV grid:
    1e-5 in f32, the bf16 tolerance (rtol 2^-6, atol 1e-2*max|ref|) in bf16
    (p rounds to bf16 at other maxima). The port takes the TPU schedule
    arguments and gives one answer for every value (mirrors
    tests/test_attention.py:48,211,223,249)."""
    ck, cv, ks, vs, _, _, q = _setup(G, quant, dtype, KV=4, seed=20 + G,
                                     scale_dtype=dtype)
    S = ck.shape[3]
    pos = np.asarray([0, S - 1, S + 5, 11], np.int32)
    H = q.shape[1]
    slopes = np.linspace(0.05, 0.9, H).astype(np.float32) if alibi else None
    scale = 1.0 / np.sqrt(ck.shape[-1])
    want = jattn.flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        jnp.int32(2), scale,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), block_s=16,
        kv_chunk=2, interpret=True)
    targs = _torch(ck, cv, ks, vs)
    outs = [tattn.flash_decode(
        t(q), targs[0], targs[1], torch.from_numpy(pos), 2, scale,
        None if slopes is None else t(slopes), targs[2], targs[3],
        block_s=bs, kv_chunk=kc) for bs, kc in ((256, None), (8, 1))]
    np.testing.assert_array_equal(f32(outs[0]), f32(outs[1]))
    if dtype == "f32":
        np.testing.assert_allclose(f32(outs[0]), f32(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        bf16_close(outs[0], want, "K11 bf16")


def test_flash_decode_unported_schedules_raise():
    """mha_mode='ew' at G = 1 (K12) and batch_fold (K13) name their ROADMAP
    item; 'ew' at G > 1 is the one-big-dot kernel in JAX, and runs."""
    ck, cv, _, _, _, _, q = _setup(1, False, "f32")
    args = (t(q), t(ck), t(cv), 3, 0, 0.125)
    with pytest.raises(NotImplementedError, match="K12.*item 14"):
        tattn.flash_decode(*args, mha_mode="ew")
    with pytest.raises(NotImplementedError, match="K13.*item 14"):
        tattn.flash_decode(*args, batch_fold=True)
    _, _, _, _, _, _, q4 = _setup(4, False, "f32")
    tattn.flash_decode(t(q4), t(ck), t(cv), 3, 0, 0.125, mha_mode="ew")


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("alibi", [False, True])
def test_decode_attention_split_route_matches_fused(monkeypatch, quant,
                                                    alibi):
    """decode_attention with FLASH_FUSED_APPEND off (K10 then K11) writes
    the fused route's (K3's) cache bytes and returns its output within
    1e-5 in f32, and JAX's split route (kv_append_pallas +
    flash_decode_pallas, interpret) within 1e-5 (bf16 scale planes, the
    serving default)."""
    ck, cv, ks, vs, kn, vn, q = _setup(2, quant, "f32", seed=8,
                                       scale_dtype="bf16")
    pos = np.asarray([5, 31, 0, 17], np.int32)
    slopes = (np.linspace(0.05, 0.9, q.shape[1]).astype(np.float32)
              if alibi else None)
    tslopes = None if slopes is None else t(slopes)
    results = {}
    for fused in (True, False):
        monkeypatch.setattr(tattn, "FLASH_FUSED_APPEND", fused)
        targs = _torch(ck, cv, ks, vs)
        results[fused] = tattn.decode_attention(
            t(q), t(kn), t(vn), targs[0], targs[1], torch.from_numpy(pos), 1,
            alibi_slopes=tslopes, k_scale=targs[2], v_scale=targs[3])
    monkeypatch.setattr(jattn, "FLASH_FUSED_APPEND", False)
    want = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pos), jnp.int32(1),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), interpret=True)
    split, fused = results[False], results[True]
    for ref in (fused[0], want[0]):
        np.testing.assert_allclose(f32(split[0]), f32(ref), rtol=1e-5,
                                   atol=1e-5)
    for a, b, w in zip(split[1:], fused[1:], want[1:]):
        np.testing.assert_array_equal(f32(a), f32(b))
        np.testing.assert_array_equal(f32(a), f32(w))
