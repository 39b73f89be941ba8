"""K4's f32 route (``csrc/prefill_attention.cu`` ``prefill_tf32_kernel``)
as arithmetic: a numpy model of what the kernel computes on the tensor
cores - q, K and p split into two TF32 parts (hi the nearest TF32), V into
three exact ones, the truncating sums of ``mma.sync`` m16n8k8
(``tf32_mma``, measured by tests/test_torch_cuda.py
test_tf32_mma_truncates), q·Kᵀ in a fresh fragment every two k8 steps
added to S by rounding to nearest, P·V in a fresh fragment a chunk folded
in as ``acc * alpha + pv`` - held to the plain version
(``ops/attention.py`` ``flash_prefill_plain``, itself held to the JAX
kernel in tests/test_torch_attention.py) and to the exact answer. The CPU has no CUDA: the kernel itself runs in the
``cuda`` tests."""

import numpy as np
import pytest
import torch

from sleekit_tpu_torch.experiments.prefill_bench import (
    K4_F32_GATE as GATE, k4_exact, k4_gate)
from sleekit_tpu_torch.ops import attention as tattn

from tests._torch_port_util import tf32_mma, tf32_rna, tf32_trunc


def _split2(v):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def _split3(v):
    hi = tf32_trunc(v)
    r = (v - hi).astype(np.float32)
    mid = tf32_trunc(r)
    return hi, mid, (r - mid).astype(np.float32)


def _chain(frag, terms):
    """frag (zeros if None) plus a @ b for each (a, b) of ``terms`` (a
    (..., R, K), b (..., K, N)), in k8 steps, and in a step in the order of
    ``terms``: each step's eight exact products one truncating tensor-core
    sum (``tf32_mma``)."""
    a0, b0 = terms[0]
    if frag is None:
        frag = np.zeros(a0.shape[:-1] + b0.shape[-1:], np.float32)
    for j in range(0, a0.shape[-1], 8):
        for a, b in terms:
            prods = (a[..., :, None, j:j + 8].astype(np.float64)
                     * b[..., None, j:j + 8, :].swapaxes(-1, -2)
                     .astype(np.float64))
            frag = tf32_mma(frag, prods)
    return frag


def _qk(terms, qk_chain):
    """q·Kᵀ from the split terms, a fresh fragment every ``qk_chain`` k8
    steps added to the f32 sum by rounding to nearest (None: one chain
    over the head dim)."""
    D = terms[0][0].shape[-1]
    step = 8 * (qk_chain or D)
    s = None
    for j in range(0, D, step):
        f = _chain(None, [(a[..., j:j + step], b[..., j:j + step, :])
                          for a, b in terms])
        s = f if s is None else (s + f).astype(np.float32)
    return s


def model(q, k, v, scale, slopes=None, rows=None, v_parts=3, products=3,
          pv="fresh", qk_chain=2):
    """K4's f32 kernel as numpy arithmetic: q (B, T, H, D), k/v (B, KV, T,
    D) f32, the output rows ``rows`` (default all) as (B, R, H, D).
    ``v_parts`` 3 splits V exactly (hi, mid, lo), 2 as hi + rna(v - hi);
    ``products`` 1 takes one TF32 product for each of q·Kᵀ and P·V;
    ``pv`` "fresh" sums each chunk's P·V in its own fragment, "into_o"
    sums it straight into O after O * alpha; ``qk_chain`` is the kernel's
    QK_CHAIN (None: q·Kᵀ in one chain)."""
    B, T, H, D = q.shape
    G = H // k.shape[1]
    rows = np.arange(T) if rows is None else np.asarray(rows)
    qs = q[:, rows].transpose(0, 2, 1, 3)               # (B, H, R, D)
    kk = np.repeat(k, G, axis=1)                        # (B, H, T, D)
    vv = np.repeat(v, G, axis=1)
    qh, ql = _split2(qs)
    kh, kl = _split2(kk)
    vh, vm, vl = _split3(vv)
    if v_parts == 2:
        vl = tf32_rna(vv - vh)
    R = len(rows)
    m = np.full((B, H, R), -np.inf, np.float32)
    l_sum = np.zeros((B, H, R), np.float32)
    acc = np.zeros((B, H, R, D), np.float32)
    for c0 in range(0, rows.max() + 1, tattn._PREFILL_CHUNK):
        c1 = min(c0 + tattn._PREFILL_CHUNK, T)
        sel = np.nonzero(rows >= c0)[0]                 # rows that see c0
        r, col = rows[sel][:, None], np.arange(c0, c1)[None, :]
        kt = lambda x: x[:, :, c0:c1].swapaxes(-1, -2)   # noqa: E731
        qa, qb = qh[:, :, sel], ql[:, :, sel]
        terms = ([(qb, kt(kh)), (qa, kt(kl)), (qa, kt(kh))] if products == 3
                 else [(qa, kt(kh))])
        x = (_qk(terms, qk_chain) * np.float32(scale)).astype(np.float32)
        if slopes is not None:
            x = (x + (slopes[:, None, None] * (col - r).astype(np.float32)
                      ).astype(np.float32)).astype(np.float32)
        x = np.where(col <= r, x, np.float32(-np.inf))
        m_old = m[:, :, sel]
        m_new = np.maximum(m_old, x.max(-1))
        alpha = np.exp(m_old - m_new).astype(np.float32)
        p = np.exp(x - m_new[..., None]).astype(np.float32)
        l_sum[:, :, sel] = (l_sum[:, :, sel] * alpha
                            + p.sum(-1, dtype=np.float32)).astype(np.float32)
        ph, pl = _split2(p)
        vc = [a[:, :, c0:c1] for a in (vh, vm, vl)]
        terms = ([(pl, vc[0]), (ph, vc[2]), (ph, vc[1]), (ph, vc[0])]
                 if v_parts == 3 else [(pl, vc[0]), (ph, vc[2]), (ph, vc[0])])
        if products == 1:
            terms = [(ph, vc[0])]
        scaled = (acc[:, :, sel] * alpha[..., None]).astype(np.float32)
        if pv == "fresh":
            acc[:, :, sel] = (scaled + _chain(None, terms)).astype(np.float32)
        else:
            acc[:, :, sel] = _chain(scaled, terms)
        m[:, :, sel] = m_new
    out = (acc / l_sum[..., None]).astype(np.float32)
    return out.transpose(0, 2, 1, 3)


def _inputs(D, G, alibi, T=256, mean=0.0, seed=0):
    """B 1, KV 1, H = G: q and k N(mean, 1), v N(0, 1), f32 from a seed;
    the scale D^-0.5 and ALiBi slopes 0.02-0.4."""
    rng = np.random.RandomState(seed + D + G)
    q = (rng.randn(1, T, G, D) + mean).astype(np.float32)
    k = (rng.randn(1, 1, T, D) + mean).astype(np.float32)
    v = rng.randn(1, 1, T, D).astype(np.float32)
    slopes = np.linspace(0.02, 0.4, G).astype(np.float32) if alibi else None
    return q, k, v, np.float32(D ** -0.5), slopes


def _plain(q, k, v, scale, slopes):
    return tattn.flash_prefill_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        float(scale), None if slopes is None else torch.from_numpy(slopes)
    ).numpy()


def _exact(q, k, v, scale, slopes):
    """The function in f64 from the same f32 inputs."""
    t = [None if x is None else torch.from_numpy(x)
         for x in (q, k, v, slopes)]
    return k4_exact(t[0], t[1], t[2], float(scale), t[3]).numpy()


def _worst(got, want):
    """The largest |got - want| over the gate's allowance."""
    return k4_gate(torch.from_numpy(np.asarray(got)),
                   torch.from_numpy(np.asarray(want)))


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_split_tf32_model_holds_1e5(D, G, alibi):
    """The kernel's arithmetic (2-part q, K and p, 3-part V, truncating
    sums, a fresh P·V fragment a chunk) at T 256 is within the f32 gate
    of the plain version, elementwise (the model reads 0.05-0.09 of it)."""
    q, k, v, scale, slopes = _inputs(D, G, alibi)
    got = model(q, k, v, scale, slopes)
    np.testing.assert_allclose(got, _plain(q, k, v, scale, slopes),
                               rtol=GATE, atol=GATE)


def test_one_tf32_product_misses_1e5():
    """One TF32 product for q·Kᵀ and one for P·V (10 mantissa bits) misses
    the f32 gate by two orders: the split is what holds it."""
    q, k, v, scale, slopes = _inputs(64, 1, False)
    got = model(q, k, v, scale, slopes, products=1)
    assert _worst(got, _plain(q, k, v, scale, slopes)) > 10


@pytest.mark.parametrize("v_parts,exact", [(3, True), (2, False)])
def test_row0_is_v_row0_with_three_part_v(v_parts, exact):
    """Row 0 has p = 1 on key 0 alone: with V in three exact TF32 parts
    each partial sum is a prefix of v's bits and row 0 is V's row 0 bit
    for bit; with V as hi + rna(v - hi) (13 bits into 11) it is not."""
    q, k, v, scale, slopes = _inputs(128, 4, True, T=64, seed=3)
    got = model(q, k, v, scale, slopes, rows=[0], v_parts=v_parts)
    want = np.repeat(v[:, :, 0], 4, axis=1)
    assert np.array_equal(got[:, 0], want) == exact


@pytest.mark.parametrize("pv", ["fresh", "into_o"])
def test_pv_over_t1024(pv):
    """The result found for P·V's accumulation at T 1024 (16 chunks, the
    last tile's rows, D 64): a fresh fragment a chunk reads 0.014 of the
    gate, the chunks summed straight into O (512 truncating sums) 0.14;
    both hold it, and the kernel takes the fresh fragment, the plain
    version's order."""
    q, k, v, scale, slopes = _inputs(64, 1, False, T=1024, seed=2)
    rows = np.arange(960, 1024)
    worst = _worst(model(q, k, v, scale, slopes, rows=rows, pv=pv),
                   _plain(q, k, v, scale, slopes)[:, rows])
    assert worst <= (0.1 if pv == "fresh" else 0.3), worst


def test_large_logits_f32_itself_misses_1e5():
    """q and k of mean 3 (logits about 72 at D 64), ALiBi at T 1024, G 4:
    the f32 plain version is itself past the gate from the exact answer
    (2.5x in these rows), so no f32 route can be held to it against the
    plain version there (the model reads 2.4x against the plain version);
    the split-TF32 model stays within 1.5x of the plain version's own
    distance from the exact answer (it reads 1.1x, 0.45 of the plain
    version's)."""
    q, k, v, scale, slopes = _inputs(64, 4, True, T=1024, mean=3.0, seed=1)
    rows = np.concatenate([np.arange(448, 512), np.arange(960, 1024)])
    exact = _exact(q, k, v, scale, slopes)[:, rows]
    plain_off = _worst(_plain(q, k, v, scale, slopes)[:, rows], exact)
    model_off = _worst(model(q, k, v, scale, slopes, rows=rows), exact)
    assert plain_off > 1.0
    assert model_off <= 1.5 * plain_off, (model_off, plain_off)


def _mean1(D, **kw):
    """q and k of mean 1, ALiBi at T 1024, G 4, in two 64-row tiles (the
    8th and the last): the model, the plain version and the exact
    answer."""
    q, k, v, scale, slopes = _inputs(D, 4, True, T=1024, mean=1.0, seed=1)
    rows = np.concatenate([np.arange(448, 512), np.arange(960, 1024)])
    return (model(q, k, v, scale, slopes, rows=rows, **kw),
            _plain(q, k, v, scale, slopes)[:, rows],
            _exact(q, k, v, scale, slopes)[:, rows])


@pytest.mark.parametrize("D", [64, 80, 128])
def test_split_tf32_model_mean1_t1024(D):
    """At large logits that f32 itself holds (q and k of mean 1, ALiBi at
    T 1024), the kernel's arithmetic is within the f32 gate of the plain
    version and of the exact answer, elementwise."""
    got, plain, exact = _mean1(D)
    np.testing.assert_allclose(got, plain, rtol=GATE, atol=GATE)
    np.testing.assert_allclose(got, exact, rtol=GATE, atol=GATE)


def test_qk_in_one_chain_drifts_at_mean1():
    """The result found for q·Kᵀ's accumulation at D 128, q and k of mean
    1: one tensor-core chain over the head dim (48 truncating sums, each
    cutting the products 25 bits below S) reads 0.65 of the gate from the
    exact answer, a fresh fragment every two k8 steps added by rounding to
    nearest 0.18, as close as f32 logits rounded once; the kernel takes
    the fresh fragments."""
    chain, _, exact = _mean1(128, qk_chain=None)
    fresh = _mean1(128)[0]
    assert _worst(chain, exact) > 2 * _worst(fresh, exact), (
        _worst(chain, exact), _worst(fresh, exact))
