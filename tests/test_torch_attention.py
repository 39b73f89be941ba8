"""The port's attention kernels - K3 (fused append + flash decode), K4
(causal flash prefill), and the split route's K10 (append) and K11-K13
(flash decode and its elementwise and batch-folded schedules): their plain
versions, which the wrappers take for CPU tensors, against the JAX Pallas
kernels in interpret mode; the port's oracle against the XLA oracle; the
schedule knobs' dispatch (mirrors tests/test_attention.py:64,334,386,484,
518,563); the decode kernels' split plan."""

import re
from pathlib import Path

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


def test_prefill_kernel_chunk_is_plain_chunk():
    """K4's key chunk (BS in csrc/prefill_attention.cu, read as text)
    equals the plain version's _PREFILL_CHUNK, so both round p to bf16
    against the same running maxima."""
    import re
    from pathlib import Path

    src = (Path(tattn.__file__).resolve().parents[1] / "csrc"
           / "prefill_attention.cu").read_text()
    found = re.findall(r"constexpr int BS = (\d+);", src)
    assert found == [str(tattn._PREFILL_CHUNK)]


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


# ---- K10 over T rows: the prefill's KV write --------------------------------


# (cache dtype, scale plane dtype, input dtype) of the prefill write: int8
# with bf16 planes (the serving default) from bf16 and f32 models, int8
# with f32 planes, and the bf16 and f32 caches.
_PREFILL_CACHES = [("int8", "bf16", "bf16"), ("int8", "bf16", "f32"),
                   ("int8", "f32", "f32"), ("bf16", None, "bf16"),
                   ("f32", None, "f32")]


def _jax_prefill_write(k, v, entry, xdt):
    """The JAX model's prefill branch at write_pos 0, composed as
    ``sleekit_tpu/models/transformer.py`` composes it, on one layer's
    entry {'k', 'v'[, 'k_scale', 'v_scale']}: returns the written entry
    and the K/V the attention reads, (B, KV, T, D)."""
    from jax import lax

    t = k.shape[1]
    kt, vt = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    cache_k, cache_v = entry["k"], entry["v"]
    new = {}
    if "k_scale" in entry:
        kq, ks = jattn._quant_rows(kt.astype(jnp.float32))
        vq, vs = jattn._quant_rows(vt.astype(jnp.float32))
        cache_k = lax.dynamic_update_slice(cache_k, kq.astype(cache_k.dtype),
                                           (0, 0, 0, 0))
        cache_v = lax.dynamic_update_slice(cache_v, vq.astype(cache_v.dtype),
                                           (0, 0, 0, 0))
        new["k_scale"] = lax.dynamic_update_slice(
            entry["k_scale"], ks[..., 0].astype(entry["k_scale"].dtype),
            (0, 0, 0))
        new["v_scale"] = lax.dynamic_update_slice(
            entry["v_scale"], vs[..., 0].astype(entry["v_scale"].dtype),
            (0, 0, 0))
        attn_k = (cache_k.astype(jnp.float32)
                  * new["k_scale"][..., None]).astype(xdt)
        attn_v = (cache_v.astype(jnp.float32)
                  * new["v_scale"][..., None]).astype(xdt)
    else:
        cache_k = lax.dynamic_update_slice(cache_k, kt.astype(cache_k.dtype),
                                           (0, 0, 0, 0))
        cache_v = lax.dynamic_update_slice(cache_v, vt.astype(cache_v.dtype),
                                           (0, 0, 0, 0))
        attn_k, attn_v = cache_k, cache_v
    new["k"], new["v"] = cache_k, cache_v
    return new, attn_k[:, :, :t], attn_v[:, :, :t]


@pytest.mark.parametrize("cache,sdt,xdt", _PREFILL_CACHES)
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
@pytest.mark.parametrize("T", [1, 17, 64])
def test_kv_prefill_write_plain_matches_jax(cache, sdt, xdt, H, KV, T):
    """K10's T-row plain version (the wrapper on CPU tensors) against the
    JAX model's prefill write on the same K/V, taken as strided slices of
    a fused qkv tensor (MHA and GQA): the written cache rows, the scale
    planes and the dequantized K/V the attention reads equal JAX's bit for
    bit, the rows past T untouched."""
    L, B, S, D, layer = 2, 3, 64, 16, 1
    d, kvd = H * D, KV * D
    jx = jnp.bfloat16 if xdt == "bf16" else jnp.float32
    rng = np.random.RandomState(T + H)
    qkv = rng.randn(B, T, d + 2 * kvd) * rng.uniform(0.01, 4, (B, T, 1))
    qkv[0, 0, d:d + D] = 0.0                  # a zero row: the scale floor
    qkv = np.asarray(jnp.asarray(qkv, jx))
    k = qkv[..., d:d + kvd].reshape(B, T, KV, D)
    v = qkv[..., d + kvd:].reshape(B, T, KV, D)
    if cache == "int8":
        ck = rng.randint(-127, 128, (L, B, KV, S, D)).astype(np.int8)
        cv = rng.randint(-127, 128, (L, B, KV, S, D)).astype(np.int8)
        sj = jnp.bfloat16 if sdt == "bf16" else jnp.float32
        ks = np.asarray(jnp.asarray(rng.rand(L, B, KV, S), sj))
        vs = np.asarray(jnp.asarray(rng.rand(L, B, KV, S), sj))
    else:
        cj = jnp.bfloat16 if cache == "bf16" else jnp.float32
        ck = np.asarray(jnp.asarray(rng.randn(L, B, KV, S, D), cj))
        cv = np.asarray(jnp.asarray(rng.randn(L, B, KV, S, D), cj))
        ks = vs = None
    entry = {"k": jnp.asarray(ck[layer]), "v": jnp.asarray(cv[layer])}
    if ks is not None:
        entry.update(k_scale=jnp.asarray(ks[layer]),
                     v_scale=jnp.asarray(vs[layer]))
    want, want_k, want_v = _jax_prefill_write(jnp.asarray(k), jnp.asarray(v),
                                              entry, jx)

    tqkv = t(qkv)
    tk = tqkv[..., d:d + kvd].reshape(B, T, KV, D)
    tv = tqkv[..., d + kvd:].reshape(B, T, KV, D)
    assert tk.stride(0) == T * (d + 2 * kvd) and tk.stride()[2:] == (D, 1)
    assert T == 1 or tk.stride(1) == d + 2 * kvd
    planes = _torch(ck, cv, ks, vs)
    got_k, got_v = tattn.kv_prefill_write(tk, tv, planes[0], planes[1],
                                          layer, planes[2], planes[3])
    np.testing.assert_array_equal(f32(got_k), f32(want_k))
    np.testing.assert_array_equal(f32(got_v), f32(want_v))
    assert got_k.dtype == tk.dtype and got_k.shape == (B, KV, T, D)
    names = ["k", "v", "k_scale", "v_scale"]
    for name, plane, before in zip(names, planes, (ck, cv, ks, vs)):
        if plane is None:
            continue
        np.testing.assert_array_equal(f32(plane[layer]), f32(want[name]))
        np.testing.assert_array_equal(f32(plane[0]), f32(before[0]))


def test_launch_append_checks_the_rows():
    """K10's launch checks its rows before any launch: T rows from pos
    must fit the slot cache, and T > 1 takes neither a page table nor a
    position vector."""
    L, B, KV, S, D = 1, 2, 2, 16, 8
    ck = torch.zeros(L, B, KV, S, D, dtype=torch.int8)
    ks = torch.zeros(L, B, KV, S, dtype=torch.bfloat16)
    k = torch.randn(B, S + 1, KV, D)
    before = tattn.K10.launches
    with pytest.raises(ValueError, match="slot cache"):
        tattn.launch_append(tattn.K10, k, k, ck, ck.clone(), 0, 0, ks,
                            ks.clone())
    with pytest.raises(ValueError, match="slot cache"):
        tattn.launch_append(tattn.K10, k[:, :S], k[:, :S], ck, ck.clone(),
                            torch.zeros(B, dtype=torch.int32), 0, ks,
                            ks.clone())
    with pytest.raises(ValueError, match="unit stride"):
        tattn.launch_append(tattn.K10, k.transpose(2, 3), k.transpose(2, 3),
                            ck, ck.clone(), 0, 0, ks, ks.clone())
    assert tattn.K10.launches == before


@pytest.mark.parametrize("D,itemsize,strides,offsets,want", [
    (64, 2, (4096, 1024, 64), (0, 4096), 8),     # bf16 rows of 128 bytes
    (128, 4, (8192, 1024, 128), (0, 4096), 4),   # f32 rows: 16 bytes, 4
    (36, 2, (72, 72, 36), (0, 16), 4),           # 72-byte rows: 8 bytes
    (64, 2, (4096, 1024, 64), (2, 4098), 1),     # 2-byte aligned pointers
    (64, 2, (4098, 1026, 64), (0, 4096), 2),     # odd token stride / 2
    (37, 4, (37, 37, 37), (0, 0), 1)])
def test_append_vec_width(D, itemsize, strides, offsets, want):
    """A lane of K10 moves the most elements, up to 16 bytes, that divide
    the row, every stride and every pointer's alignment; an int8 cache
    needs its pointer aligned to the chunk's elements."""
    base = 1 << 20
    ptrs = [(base + o, itemsize) for o in offsets]
    assert tattn.append_vec(D, strides, ptrs) == want
    cache = [(base + 4, 1)]                       # int8: aligned to 4 only
    assert tattn.append_vec(D, strides, ptrs + cache) == min(want, 4)


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


@pytest.mark.parametrize("dtype,block_s", [("f32", 32), ("f32", 8),
                                           ("bf16", 8)])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_ew_plain_matches_jax_kernel(dtype, block_s, alibi,
                                                  quant):
    """K12's plain version (mha_mode='ew' at G = 1) == flash_decode_pallas
    (mha_mode='ew', interpret), multi-S-block online softmax: 1e-5 in f32;
    with bf16 q (bf16 cache or bf16 scale planes) within one bf16 step,
    since both keep everything in f32 and round only the output (mirrors
    tests/test_attention.py:334)."""
    ck, cv, ks, vs, _, _, q = _setup(1, quant, dtype, KV=8, seed=30,
                                     scale_dtype=dtype)
    S = ck.shape[3]
    pos = np.asarray([0, S - 1, S + 5, 11], np.int32)
    slopes = np.linspace(0.05, 0.9, 8).astype(np.float32) if alibi else None
    scale = 1.0 / np.sqrt(ck.shape[-1])
    want = jattn.flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        jnp.int32(1), scale,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), block_s=block_s,
        interpret=True, mha_mode="ew")
    targs = _torch(ck, cv, ks, vs)
    got = tattn.flash_decode(
        t(q), targs[0], targs[1], torch.from_numpy(pos), 1, scale,
        None if slopes is None else t(slopes), targs[2], targs[3],
        block_s=block_s, mha_mode="ew")
    assert got.dtype == t(q).dtype
    if dtype == "f32":
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(f32(got), f32(want), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_bfold_plain_matches_jax_kernel(G, alibi, quant):
    """K13's plain version (batch_fold, K11's) == flash_decode_pallas
    (batch_fold, block_s 8, interpret) over GQA, ALiBi, int8 scales and
    clamped ragged positions, 1e-5 in f32 (mirrors
    tests/test_attention.py:64)."""
    ck, cv, ks, vs, _, _, q = _setup(G, quant, "f32", seed=40 + G)
    S = ck.shape[3]
    pos = np.asarray([3, S - 1, S + 2, 20], np.int32)
    H = q.shape[1]
    slopes = np.linspace(0.05, 0.9, H).astype(np.float32) if alibi else None
    scale = 1.0 / np.sqrt(ck.shape[-1])
    want = jattn.flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        jnp.int32(2), scale,
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), block_s=8,
        interpret=True, batch_fold=True)
    targs = _torch(ck, cv, ks, vs)
    got = tattn.flash_decode(
        t(q), targs[0], targs[1], torch.from_numpy(pos), 2, scale,
        None if slopes is None else t(slopes), targs[2], targs[3],
        block_s=8, batch_fold=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("knobs,G,want", [
    ({}, 1, "K11"),
    ({"FLASH_MHA_MODE": "ew"}, 1, "K12"),
    ({"FLASH_MHA_MODE": "ew"}, 4, "K11"),
    ({"FLASH_BATCH_FOLD": True}, 1, "K13"),
    ({"FLASH_BATCH_FOLD": True}, 4, "K13"),
    ({"FLASH_MHA_MODE": "ew", "FLASH_BATCH_FOLD": True}, 1, "K12"),
    ({"FLASH_MHA_MODE": "ew", "FLASH_BATCH_FOLD": True}, 4, "K13")])
def test_flash_decode_knob_dispatch(monkeypatch, knobs, G, want):
    """The knobs select the flash-decode kernel as the JAX package does
    (sleekit_tpu/ops/attention.py:971-973): 'ew' only at G = 1, where it
    wins over the batch fold; explicit arguments win over the knobs. On
    CPU tensors flash_decode takes the selected kernel's plain version
    (bf16 q: K12's f32 numerics differ from K11's)."""
    for name, value in knobs.items():
        monkeypatch.setattr(tattn, name, value)
    ck, cv, ks, vs, _, _, q = _setup(G, True, "bf16", seed=50 + G,
                                     scale_dtype="bf16")
    targs = _torch(ck, cv, ks, vs)
    kernel, plain = tattn.decode_route(t(q), targs[0])
    assert kernel.name == want
    assert plain is (tattn.flash_decode_ew_plain if want == "K12"
                     else tattn.flash_decode_plain)
    args = (t(q), targs[0], targs[1], torch.tensor([0, 31, 9, 20],
                                                   dtype=torch.int32), 1,
            0.125, None, targs[2], targs[3])
    assert torch.equal(tattn.flash_decode(*args), plain(*args))
    if G == 1:
        ew = tattn.flash_decode_ew_plain(*args)
        assert torch.equal(ew, tattn.flash_decode(*args)) == (want == "K12")
    assert tattn.decode_route(t(q), targs[0], "dot", False)[0] is tattn.K11


def test_fused_route_ignores_schedule_knobs(monkeypatch):
    """With FLASH_FUSED_APPEND on, decode_attention takes K3 whatever
    FLASH_MHA_MODE and FLASH_BATCH_FOLD say, as in the JAX package
    (sleekit_tpu/ops/attention.py:1272); the split route takes the
    selected kernel's plain version."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(tattn, name, wrapped)

    for name in ("flash_decode_ew_plain", "flash_decode_plain",
                 "fused_decode_append_plain"):
        spy(name, getattr(tattn, name))
    monkeypatch.setattr(tattn, "FLASH_MHA_MODE", "ew")
    monkeypatch.setattr(tattn, "FLASH_BATCH_FOLD", True)
    ck, cv, ks, vs, kn, vn, q = _setup(1, True, "bf16", seed=9,
                                       scale_dtype="bf16")
    for fused, want in ((True, "fused_decode_append_plain"),
                        (False, "flash_decode_ew_plain")):
        monkeypatch.setattr(tattn, "FLASH_FUSED_APPEND", fused)
        targs = _torch(ck, cv, ks, vs)
        calls.clear()
        tattn.decode_attention(t(q), t(kn), t(vn), targs[0], targs[1], 7, 0,
                               k_scale=targs[2], v_scale=targs[3])
        assert calls == [want]


@pytest.mark.parametrize("family", ["opt", "llama"])
@pytest.mark.parametrize("knobs", [{"FLASH_MHA_MODE": "ew"},
                                   {"FLASH_BATCH_FOLD": True},
                                   {"FLASH_MHA_MODE": "ew",
                                    "FLASH_BATCH_FOLD": True}])
def test_decode_step_split_route_knobs(monkeypatch, family, knobs):
    """decode_step of a tiny bf16 int4 model (OPT: MHA, G = 1; Llama: GQA,
    G = 2, where 'ew' falls back to K11) with an int8 KV cache on the
    split route under each knob: its logits within the bf16 tolerance of
    the default (fused) route's, and the first layer's cache bytes equal
    (later layers' new K/V carry the attention's rounding)."""
    from sleekit_tpu_torch.models import transformer as ttr
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.quantize import pack_lm_head
    from sleekit_tpu_torch.models.zoo import tiny_test

    geo = {"opt": {}, "llama": dict(activation="silu_glu", norm="rmsnorm",
                                    positional="rope", n_kv_heads=2,
                                    tie_embeddings=False)}[family]
    cfg = tiny_test(dtype=torch.bfloat16, **geo)
    params, _ = random_packed_params(cfg, 3, fuse_qkv=True, device="cpu")
    params = pack_lm_head(cfg, params, nbits=8)
    tokens = torch.as_tensor(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (3, 20)))
    cache = ttr.init_kv_cache(cfg, 3, 32, torch.int8, device="cpu")
    ttr.prefill(cfg, params, tokens, cache)
    nxt = tokens[:, -1:]
    pos = torch.tensor([20, 20, 20], dtype=torch.int32)
    results = []
    for split in (False, True):
        monkeypatch.setattr(tattn, "FLASH_FUSED_APPEND", not split)
        for name, value in knobs.items():
            monkeypatch.setattr(tattn, name, value if split else
                                {"FLASH_MHA_MODE": "dot"}.get(name, False))
        c = {k: v.clone() for k, v in cache.items()}
        results.append(ttr.decode_step(cfg, params, nxt, c, pos)[0])
        results.append(c)
    bf16_close(results[2], results[0], f"{family} split route {knobs}")
    for k in cache:
        assert torch.equal(results[1][k][0], results[3][k][0])


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


_DECODE_SRC = (Path(tattn.__file__).resolve().parents[1] / "csrc"
               / "decode_attention.cu")


@pytest.mark.parametrize("D", [8, 16, 48, 64, 80, 128, 256])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
def test_decode_plan_tiles_the_capacity(D, itemsize):
    """The decode-attention kernels' split (``decode_plan``): R rows a
    split, a multiple of 16 and of a block step's rows (the source's
    THREADS / 32 warps of 32 / lanes rows), from MIN_ROWS to MAX_ROWS, as
    many as DECODE_SPLIT_BYTES of K rows hold where a step fits, a function
    of D and the cache dtype alone; the splits tile every capacity once;
    the scratch holds (B, KV, splits, G, D + 2) f32, the last element the
    kernel indexes included."""
    src = _DECODE_SRC.read_text()
    assert "constexpr int THREADS = 128;" in src
    assert tattn.DECODE_WARPS == 128 // 32
    assert f"constexpr int MIN_ROWS = {tattn.DECODE_MIN_ROWS};" in src
    assert f"constexpr int MAX_ROWS = {tattn.DECODE_MAX_ROWS};" in src
    lanes = tattn.decode_lanes(D, itemsize)
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert lanes * 16 >= min(D * itemsize, 32 * 16)
    step = max(16, tattn.DECODE_WARPS * (32 // lanes))
    row_bytes = -(-D * itemsize // 16) * 16
    plans = set()
    for B, KV, G in [(1, 1, 1), (8, 32, 1), (3, 8, 4), (5, 2, 8)]:
        for capacity in (1, 63, 64, 65, 300, 512, 4096):
            R, splits, nbytes = tattn.decode_plan(B, KV, G, D, itemsize,
                                                  capacity)
            plans.add(R)
            assert R % 16 == 0 and R % step == 0
            assert tattn.DECODE_MIN_ROWS <= R <= tattn.DECODE_MAX_ROWS
            assert R == step or R * row_bytes <= tattn.DECODE_SPLIT_BYTES
            assert (R + step > tattn.DECODE_MAX_ROWS or (R + step) * row_bytes
                    > tattn.DECODE_SPLIT_BYTES)
            cuts = [(c * R, min((c + 1) * R, capacity))
                    for c in range(splits)]
            assert cuts[0][0] == 0 and cuts[-1][1] == capacity
            assert all(a < b for a, b in cuts)
            assert all(cuts[i][1] == cuts[i + 1][0]
                       for i in range(splits - 1))
            assert nbytes == 4 * B * KV * splits * G * (D + 2)
            last = (((((B - 1) * KV + KV - 1) * splits + splits - 1) * G
                     + G - 1) * (D + 2) + D + 1)
            assert 4 * (last + 1) == nbytes
    assert len(plans) == 1


def test_decode_plan_slot_and_pool_agree(monkeypatch):
    """A slot cache and a page pool of the same capacity (S = MAXP * PS)
    get the same plan from the wrappers, which hand it to the kernel: R,
    splits, and one allocation a call that holds the output, then the
    plan's scratch from a 16-byte boundary."""
    seen = []

    class Spy:
        def __call__(self, *args):
            seen.append(args[-6:-4])    # (R, splits)

    empty = torch.empty
    sizes = []

    def spy_empty(*shape, **kw):
        sizes.append(shape[0] if len(shape) == 1 else shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(tattn.torch, "empty", spy_empty)
    L, B, KV, G, D, PS, MAXP = 2, 3, 2, 4, 64, 16, 20
    S = PS * MAXP
    q = torch.zeros(B, KV * G, D, dtype=torch.bfloat16)
    slot = torch.zeros(L, B, KV, S, D, dtype=torch.int8)
    sc = torch.ones(L, B, KV, S, dtype=torch.bfloat16)
    pool = torch.zeros(L, B * MAXP + 1, KV, PS, D, dtype=torch.int8)
    psc = torch.ones(L, B * MAXP + 1, KV, PS, dtype=torch.bfloat16)
    table = torch.arange(1, B * MAXP + 1, dtype=torch.int32).reshape(B, MAXP)
    tattn.launch_decode(Spy(), q, None, None, slot, slot, 7, 1, 0.125, None,
                        sc, sc)
    tattn.launch_decode(Spy(), q, None, None, pool, pool, 7, 1, 0.125, None,
                        psc, psc, table)
    R, splits, nbytes = tattn.decode_plan(B, KV, G, D, 1, S)
    assert seen == [(R, splits), (R, splits)]
    out_bytes = -(-B * KV * G * D * 2 // 16) * 16
    assert sizes == [(out_bytes + nbytes) // 2] * 2


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("pos", [256, 272, 287])
def test_decode_plan_fills_the_card(pos, fused):
    """At OPT-1.3B decode (batch 8, 32 KV heads, D 64, an int8 cache of 512
    rows), the live splits give at least 2 blocks an SM of the H100's 132
    at the decode step's positions 272-287, for the flash kernels (rows
    s <= pos) and the fused ones (s < pos: the token comes from
    registers), and at pos 256 for the flash kernels. The fused kernels
    at pos 256 read exactly one split of R = 256 rows: 256 blocks, 1.94 an
    SM. R = 128 would give them two splits, but measured slower on the
    main path at pos 256 and 280 and in the graph-replayed step on an
    H100 (PERF.md, the decode-attention findings), so the plan keeps 256
    and this case states the count."""
    B, KV = 8, 32
    R, splits, _ = tattn.decode_plan(B, KV, 1, 64, 1, 512)
    blocks = B * KV * -(-(pos if fused else pos + 1) // R)
    if fused and pos == 256:
        assert R == 256 and blocks == B * KV
    else:
        assert blocks >= 2 * 132
    assert splits * R >= 512
