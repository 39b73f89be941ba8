"""The 'plane' layout at f32 activations (kernels K8f and K9f) against the
JAX package: their plain versions, reached through ``quantized_matmul``'s
dispatch, against the Pallas kernel in interpret mode (f32
``compute_dtype``); the bf16 plain versions as they were, bit for bit;
K8f/K9f's tile plan and their tiled route's split-TF32 product,
emulated in numpy; and the path that runs them, ``quantize_model_cli
--codebook nf4`` and
``--codebook lloyd`` (every linear packed 'plane') with ``--eval-ppl``,
then ``serve_cli`` on the NF4 checkpoint, port against JAX on a tiny OPT
from an HF-layout checkpoint."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleekit_tpu.experiments import quantize_model_cli as jq_cli
from sleekit_tpu.experiments import serve_cli as js_cli
from sleekit_tpu.ops import dequant_matmul as jdm
from sleekit_tpu_torch.experiments import quantize_model_cli as tq_cli
from sleekit_tpu_torch.experiments import serve_cli as ts_cli
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models import zoo as tzoo
from sleekit_tpu_torch.ops import dequant_matmul as tdm
from sleekit_tpu_torch.ops.pack import unpack_indices
from sleekit_tpu_torch.serve.checkpoint import load_packed_params

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    TINY_OPT, f32, one_torch_thread, run_main, t, tf32_mma, tf32_rna,
    tf32_trunc, tiny_opt_checkpoint)
from tests.test_torch_dequant_matmul import PLANE_LUTS, _pair, _plane

QUANT_ARGS = ["--model", TINY_OPT, "--samples", "16", "--seq-len", "32",
              "--batch", "32", "--preset", "light", "--nbits", "4",
              "--eval-ppl"]
SERVE_ARGS = ["--model", TINY_OPT, "--random", "4", "--prompt-len", "12",
              "--max-new-tokens", "6", "--max-seq-len", "128"]


def _taken(monkeypatch):
    """The names of the plain functions that the calls after this one
    reach, in order: K8/K8f's, K9/K9f's and the reference."""
    taken = []
    for fn in ("plane_lut_matmul_plain", "plane_affine_matmul_plain",
               "dequant_matmul_ref"):
        monkeypatch.setattr(tdm, fn, lambda *a, _o=getattr(tdm, fn), _n=fn,
                            **k: taken.append(_n) or _o(*a, **k))
    return taken


@pytest.mark.parametrize("m", [3, 64])
@pytest.mark.parametrize("name", list(PLANE_LUTS))
def test_plane_f32_plain_matches_jax_kernel(name, m, monkeypatch):
    """K8f (NF4, a k = 3 table at 2 bits, an unsorted 8-entry table, the
    8-bit affine grid) and K9f (uniform 3 and 4 bits, the ternary grid at
    2 bits) plain versions, reached through quantized_matmul's dispatch
    with f32 x, == dequant_matmul_pallas (interpret: the Pallas kernel at
    its f32 compute_dtype) over 'plane' words at K 700 (off every plane
    tile), within 1e-5 of the largest |y|: K9f folds over C - 1.5 where
    JAX folds over C (its a*(x@C) and b*rowsum cancel), and XLA computes
    the 8-bit grid's idx*step + zero as one fused multiply-add where the
    port rounds the product first. The f32 plain version is the one
    taken (not dequant_matmul_ref), and the output is f32."""
    rng = np.random.RandomState(len(name) + m)
    jw, tw = _plane(rng, PLANE_LUTS[name], 700, 96)
    x = rng.randn(m, 700).astype(np.float32)
    want = np.asarray(jdm.dequant_matmul_pallas(jnp.asarray(x), jw,
                                                interpret=True))
    taken = _taken(monkeypatch)
    for use_kernel in (False, True):
        got = tdm.quantized_matmul(t(x), tw, use_kernel=use_kernel)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(f32(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    kind = "lut" if tw.affine is None or tw.nbits == 8 else "affine"
    assert taken == [f"plane_{kind}_matmul_plain"] * 2


@pytest.mark.parametrize("name", ["nf4", "table8", "affine8", "uniform4",
                                  "ternary"])
def test_plane_bf16_plain_unchanged(name):
    """At bf16 x the plain versions of K8 and K9 compute as they did
    before the f32 route, bit for bit: K8 ``bf16((x @ bf16(v[idx])) *
    scale + bias)``, K9 ``bf16((a*(x @ (C - 1.5)) + (b + 1.5a)*rowsum(x))
    * scale + bias)``, f32 products and sums."""
    rng = np.random.RandomState(3)
    _, tw = _plane(rng, PLANE_LUTS[name], 700, 96)
    x = t(rng.randn(5, 700).astype(np.float32)).to(torch.bfloat16)
    idx = unpack_indices(tw.packed, tw.nbits, 700, layout="plane").long()
    xf = x.float()
    if tw.affine is None or tw.nbits == 8:
        if tw.affine is not None:
            step, zero = (torch.tensor(v, dtype=torch.float32)
                          for v in tw.affine)
            vals = torch.arange(2 ** tw.nbits, dtype=torch.float32) * step \
                + zero
        else:
            vals = torch.zeros(2 ** tw.nbits)
            vals[:tw.lut.shape[0]] = tw.lut
        want = ((xf @ vals.to(torch.bfloat16).float()[idx]) * tw.scale
                + tw.bias).to(torch.bfloat16)
    else:
        a, b = tdm._pair_affine(tw)
        c = idx.float() / float(2 ** tw.nbits) - 0.5
        want = ((a * (xf @ c) + (b + 1.5 * a) * xf.sum(dim=1, keepdim=True))
                * tw.scale + tw.bias).to(torch.bfloat16)
    got = tdm.quantized_matmul(x, tw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want), name


def test_plane_dispatch_by_dtype_and_split(monkeypatch):
    """On the CPU, quantized_matmul sends 'plane' at bf16 and f32 x to
    K8/K8f's and K9/K9f's plain versions (the kernels on the card);
    'plane' with k_splits > 1 (a tensor-parallel row-shard format) raises,
    naming localize_packed_shard, as the JAX package's matmuls do; the f32
    'pair' layout (the JAX package's XLA route) reaches
    dequant_matmul_ref."""
    import dataclasses

    rng = np.random.RandomState(0)
    _, nf4 = _plane(rng, PLANE_LUTS["nf4"], 256, 32)
    _, uni = _plane(rng, PLANE_LUTS["uniform4"], 256, 32)
    _, pair = _pair(rng, 4, 256, 32)
    x = torch.from_numpy(rng.randn(2, 256).astype(np.float32))
    taken = _taken(monkeypatch)
    for w in (nf4, uni):
        for xx in (x, x.to(torch.bfloat16)):
            tdm.quantized_matmul(xx, w)
    assert taken == ["plane_lut_matmul_plain"] * 2 + [
        "plane_affine_matmul_plain"] * 2
    taken.clear()
    with pytest.raises(ValueError, match="localize_packed_shard"):
        tdm.quantized_matmul(x, dataclasses.replace(nf4, k_splits=2))
    tdm.quantized_matmul(x, pair)
    assert taken == ["dequant_matmul_ref"]


# ---- K8f/K9f's tiled route: its plan and its split-TF32 product ----------

# f32_tile_plan at OPT-1.3B's projections (q, k, v, o: N 2048; the fused
# qkv 6144; fc1 8192; fc2 K 8192) on 132 SMs, at the f32 commands' M.
_TILE_PLANS = {(512, 2048, 2048): 2, (512, 6144, 2048): 2,
               (512, 8192, 2048): 1, (512, 2048, 8192): 2,
               (2048, 2048, 2048): 1, (2048, 6144, 2048): 1,
               (2048, 8192, 2048): 1, (2048, 2048, 8192): 1}


@pytest.mark.parametrize("m,n,k", list(_TILE_PLANS))
def test_f32_tile_plan_fills_the_sms(m, n, k):
    """K8f/K9f's tile plan at eval_ppl's M (2 x 256) and serve_cli's
    prefill M (8 x 256): F32_TILE_M x F32_TILE_N tiles whose grid reaches
    the H100's 132 SMs or, where the tiles alone do not (512 rows at N
    2048: 64 tiles), a K split named by the plan (2: 128 blocks, one wave
    of half the steps); at 512 rows of the fused qkv (192 tiles, a wave
    and a half) a split into 384 blocks, three waves of half the steps;
    each slice at least F32_TILE_MIN_STEPS steps of 32 rows, the splits at
    most 2 x 132 over the tiles; no split at 2048 rows."""
    splits = tdm.f32_tile_plan(m, n, k, 132)
    assert splits == _TILE_PLANS[m, n, k]
    tiles = -(-m // tdm.F32_TILE_M) * -(-n // tdm.F32_TILE_N)
    assert tiles >= 132 or splits > 1
    assert splits <= -(-2 * 132 // tiles)
    assert -(-k // 32) // splits >= tdm.F32_TILE_MIN_STEPS


def _tile_product(x, w, products):
    """x @ w as the tiled route forms it: each operand as hi = tf32(v) and
    lo = tf32(v - hi); the ``products`` a_lo*b_hi, a_hi*b_lo, a_hi*b_hi
    (3), a_lo*b_hi, a_hi*b_hi (2: b_lo = 0), or a_hi*b_hi alone (1);
    each 32-row step's sum taken exactly, rounded to f32 and added into
    f32 sums in step order (the fresh fragment a step, then
    ``__fadd_rn``)."""
    steps = x.shape[1] // 32
    xs = x.reshape(x.shape[0], steps, 32).transpose(1, 0, 2)
    ws = w.reshape(steps, 32, w.shape[1])
    xh, wh = tf32_rna(xs), tf32_rna(ws)
    xl, wl = tf32_rna(xs - xh), tf32_rna(ws - wh)
    terms = {3: [(xl, wh), (xh, wl), (xh, wh)], 2: [(xl, wh), (xh, wh)],
             1: [(xh, wh)]}[products]
    part = sum(np.matmul(a.astype(np.float64), b.astype(np.float64))
               for a, b in terms).astype(np.float32)
    acc = np.zeros(part.shape[1:], np.float32)
    for p in part:
        acc = acc + p
    return acc


@pytest.mark.parametrize("name", ["nf4", "affine8", "uniform4"])
def test_split_tf32_holds_1e5_at_fc2(name):
    """The tiled route's split-TF32 product, emulated in numpy, at fc2's
    shape (K 8192, N 2048) with x >= 0 (after the relu: sums that grow one
    way): three products over K8f's NF4 table and 8-bit grid, two over
    K9f's C - 1.5 (exact in TF32, so its lo is 0), land within 1e-5 of
    the largest |output| of the plain versions' f32 product (PyTorch's),
    while one TF32 product misses that gate."""
    rng = np.random.RandomState(21)
    m, k, n = 8, 8192, 2048
    values = {"nf4": np.asarray(PLANE_LUTS["nf4"], np.float32),
              "affine8": np.arange(256, dtype=np.float32)
              * np.float32(2.0 / 255) + np.float32(-1.0),
              "uniform4": np.arange(16, dtype=np.float32) / 16 - 0.5}[name]
    x = np.abs(rng.randn(m, k)).astype(np.float32)
    w = values[rng.randint(0, len(values), (k, n))]
    plain = (torch.from_numpy(x) @ torch.from_numpy(w)).numpy()
    top = np.abs(plain).max()
    products = 3
    if name == "uniform4":
        assert np.array_equal(tf32_rna(values), values)
        products = 2
    assert np.abs(_tile_product(x, w, products) - plain).max() <= 1e-5 * top
    assert np.abs(_tile_product(x, w, 1) - plain).max() > 1e-5 * top


@pytest.mark.parametrize("chain,holds", [(1024, False), (16, True)])
def test_tile_chain_holds_1e5(chain, holds):
    """The tiled route's accumulation rule at fc2's K = 8192 with x >= 0
    and NF4 weights, emulated with the tensor cores' truncating sums: one
    fragment over all of K (1,024 chunks of 8 K, 3 products each) drifts
    past 1e-5 of the largest output, fresh fragments of 16 chunks
    (TILE_CHAIN = 4 steps of 32 K) added into f32 sums stay within it."""
    rng = np.random.RandomState(4)
    m, k, n = 2, 8192, 128
    x = np.abs(rng.randn(m, k)).astype(np.float32)
    nf4 = np.asarray(PLANE_LUTS["nf4"], np.float32)
    w = nf4[rng.randint(0, 16, (k, n))]
    exact = x.astype(np.float64) @ w.astype(np.float64)
    xh = tf32_trunc(x)
    xl, wh = tf32_rna(x - xh), tf32_rna(w)
    wl = tf32_rna(w - wh)
    acc = np.zeros(m * n, np.float32)
    frag = acc.copy()
    for c in range(k // 8):
        if c % chain == 0:
            frag = np.zeros(m * n, np.float32)
        for a, b in ((xl, wh), (xh, wl), (xh, wh)):
            prods = (a[:, None, 8 * c:8 * c + 8].astype(np.float64)
                     * b[8 * c:8 * c + 8].T[None].astype(np.float64))
            frag = tf32_mma(frag, prods.reshape(m * n, 8))
        if c % chain == chain - 1:
            acc = (acc + frag).astype(np.float32)
    err = np.abs(acc.reshape(m, n) - exact).max() / np.abs(exact).max()
    assert (err <= 1e-5) == holds, err


# ---- K8f/K9f's streaming route: its plan and its split-TF32 product -----

# f32_stream_plan at OPT-1.3B's projections ((K, N): the fused qkv, o, fc1,
# fc2) and at a narrow fc2-like (K 8192, N 256) over 4-bit words on 132
# SMs: (32-column strips, K splits = cluster size).
_STREAM_PLANS = {(2048, 6144): (192, 1), (2048, 2048): (64, 2),
                 (2048, 8192): (256, 1), (8192, 2048): (64, 2),
                 (8192, 256): (8, 8)}


@pytest.mark.parametrize("k,n", list(_STREAM_PLANS))
def test_f32_stream_plan_fills_the_sms(k, n):
    """K8f/K9f's streaming plan at decode: F32_STREAM_COLS-column strips,
    K split where the strips alone leave SMs idle (o and fc2: 64 strips,
    2 splits; N = 256: 8 strips, 8 splits), the splits a power of two of
    at most F32_MAX_CLUSTER (one cluster), the blocks at most one an SM
    (every cluster resident at once), and every warp of a slice (twice
    STREAM_WARPS where K splits) at least one unit of F32_UNIT_ROWS word
    rows."""
    kw = k // 256 * 32
    strips, splits = tdm.f32_stream_plan(n, kw, 4, 132)
    assert (strips, splits) == _STREAM_PLANS[k, n]
    assert strips == -(-n // tdm.F32_STREAM_COLS)
    assert splits <= tdm.F32_MAX_CLUSTER and splits & (splits - 1) == 0
    assert splits == 1 or strips * splits <= 132
    units = tdm.f32_stream_units(kw, 4)
    assert units == kw // tdm.F32_UNIT_ROWS
    assert units // splits >= tdm.STREAM_WARPS * (2 if splits > 1 else 1)


def _stream_product(x, w, products, tok=8, fresh=True):
    """x @ w (K = 8192 at 4 bits) as the streaming route forms it: a k8
    step is field j of 8 consecutive word rows (K rows 256 tile + 32 j + 8
    group + 0..7), a unit one row group's 8 fields, and the 128 units in
    16 contiguous slices of 8 (fc2's 2 splits by a block's 8 warps); x as
    hi = rna(x) and lo = x - hi, w as hi = its top 19 bits and lo = w - hi
    (the tensor cores read the top 19 bits of each register, so lo is read
    truncated too). With ``tok`` = 8 (5-8 tokens) the ``products``
    w_lo*x_hi, w_hi*x_lo, w_hi*x_hi (3) or w_hi*x_lo, w_hi*x_hi (2) a
    step, each an mma's truncating sum into a fragment of its own kind,
    fresh each unit, then added into f32 sums (``__fadd_rn``: the small
    kinds, then w_hi*x_hi); with ``tok`` = 4 (1-4 tokens, x's hi in
    columns 0-3 of the n8 and lo in 4-7) w_lo*x and w_hi*x (3) or w*x (2),
    the hi and lo columns summed apart and added at the end of the slice.
    Then the warps' sums in warp order and the splits' in rank order.
    ``fresh=False``: one fragment over all of K and every kind instead."""
    m, k = x.shape
    n = w.shape[1]
    slices = 16 if fresh else 1
    order = np.arange(k).reshape(k // 256, 8, 4, 8).transpose(0, 2, 1, 3)
    order = order.reshape(slices, -1, 8, 8)
    xh = tf32_rna(x)
    xl = tf32_trunc(x - xh)
    wh = tf32_trunc(w)
    wl = tf32_trunc(w - wh)
    if tok == 8:   # (A, B, sum) a kind: sum 0 alone
        kinds = {3: [(wl, xh), (wh, xl), (wh, xh)],
                 2: [(wh, xl), (wh, xh)]}[products]
        parts = [list(range(len(kinds)))]
    else:          # the hi columns' kinds, then the lo columns'
        a_parts = [wl, wh] if products == 3 else [wh]
        kinds = [(a, xh) for a in a_parts] + [(a, xl) for a in a_parts]
        half = len(a_parts)
        parts = [list(range(half)), list(range(half, 2 * half))]
    acc = [np.zeros((slices, m * n), np.float32) for _ in parts]
    frag = [np.zeros((slices, m * n), np.float32) for _ in kinds]
    for u in range(order.shape[1]):
        if fresh:
            frag = [np.zeros_like(f) for f in frag]
        for s in range(8):
            rows = order[:, u, s]                        # (slices, 8)
            for j, (a, b) in enumerate(kinds):
                prods = (b[:, rows].transpose(1, 0, 2)[:, :, None, :]
                         .astype(np.float64)
                         * a[rows].transpose(0, 2, 1)[:, None].astype(
                             np.float64))
                f = j if fresh else 0
                frag[f] = tf32_mma(frag[f], prods.reshape(slices, m * n, 8))
        if fresh:
            for p, kind in enumerate(parts):
                unit = frag[kind[0]]
                for j in kind[1:]:
                    unit = (unit + frag[j]).astype(np.float32)
                acc[p] = (acc[p] + unit).astype(np.float32)
    if not fresh:
        return frag[0].reshape(m, n)
    total = acc[0] if len(acc) == 1 else (acc[0] + acc[1]).astype(np.float32)
    out = np.zeros(m * n, np.float32)
    for y in range(2):
        block = np.zeros(m * n, np.float32)
        for v in range(8):
            block = (block + total[8 * y + v]).astype(np.float32)
        out = (out + block).astype(np.float32)
    return out.reshape(m, n)


@pytest.mark.parametrize("name,tok,fresh", [
    ("nf4", 4, True), ("nf4", 8, True), ("uniform4", 4, True),
    ("uniform4", 8, True), ("nf4", 8, False)])
def test_stream_route_holds_1e5(name, tok, fresh):
    """The streaming route's arithmetic at fc2's K = 8192 with x >= 0 (2
    tokens, 128 columns), emulated with the tensor cores' truncating sums:
    NF4's three products and C - 1.5's two (exact in TF32), at 1-4 tokens
    (x's hi and lo in one n8) and at 5-8, fresh fragments a unit (8 k8
    steps, one a kind of product) in f32 sums, the warps' and the splits'
    sums in order, land within 1e-5 of the largest output of the product
    taken exactly; one fragment over all of K (1,024 k8 steps) does not."""
    rng = np.random.RandomState(23)
    m, k, n = 2, 8192, 128
    x = np.abs(rng.randn(m, k)).astype(np.float32)
    values = {"nf4": np.asarray(PLANE_LUTS["nf4"], np.float32),
              "uniform4": np.arange(16, dtype=np.float32) / 16 - 0.5}[name]
    w = values[rng.randint(0, 16, (k, n))]
    exact = x.astype(np.float64) @ w.astype(np.float64)
    products = 3 if name == "nf4" else 2
    if products == 2:
        assert np.array_equal(tf32_rna(values), values)
    got = _stream_product(x, w, products, tok, fresh)
    err = np.abs(got - exact).max() / np.abs(exact).max()
    assert (err <= 1e-5) == fresh, err


# ---- the commands on the 'plane' layout -----------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The tiny OPT's HF checkpoint and one quantize run of each package
    on it for each codebook: {codebook: (jax stdout, port stdout, port
    result)}, and the root."""
    root = tmp_path_factory.mktemp("plane_cli")
    out = {"root": root}
    with tiny_opt_checkpoint(root) as hf:
        for cb in ("nf4", "lloyd"):
            argv = QUANT_ARGS + ["--codebook", cb, "--checkpoint", str(hf)]
            jout, _ = run_main(jq_cli.main, [str(root / f"jax_{cb}")] + argv)
            tout, res = run_main(tq_cli.main, [str(root / f"port_{cb}")]
                                 + argv + ["--device", "cpu"])
            out[cb] = (jout, tout, res)
        yield out


def _number(pattern, text):
    return float(re.search(pattern, text).group(1))


@pytest.mark.parametrize("cb", ["nf4", "lloyd"])
def test_plane_cli_matches_jax(runs, cb):
    """``quantize_model_cli --codebook nf4`` and ``--codebook lloyd`` of
    both packages on one HF checkpoint: the same meta, every linear
    'plane' (4 bits) in both, the same per-layer report order, the same
    packed words (bit for bit), tables and scales within 1e-6 relative;
    total error and the perplexities (fp32, quantized, decode-scored;
    JAX scores through dequant_matmul_xla on the CPU, the port through
    the plain K8f) within 1e-5 relative."""
    root = runs["root"]
    jout, tout, res = runs[cb]
    cfg = tzoo.tiny_test()
    tparams, tmeta = load_packed_params(str(root / f"port_{cb}"),
                                        device="cpu")
    jparams, jmeta = load_packed_params(str(root / f"jax_{cb}"),
                                        device="cpu")
    assert tmeta == jmeta == {"model": TINY_OPT, "preset": "light",
                              "nbits": 4, "codebook": cb}
    for name in ttr.layer_names(cfg):
        got = ttr.get_linear_param(tparams, name)
        want = ttr.get_linear_param(jparams, name)
        assert (got.layout, got.nbits, got.affine) == (
            want.layout, want.nbits, want.affine) == ("plane", 4, None)
        assert torch.equal(got.packed, want.packed), name
        np.testing.assert_allclose(got.lut.numpy(), want.lut.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got.scale.numpy(), want.scale.numpy(),
                                   rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.bias.numpy(), want.bias.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    layer_lines = [re.findall(r"^  (layers\.\S+)\s+err=", out, re.M)
                   for out in (jout, tout)]
    assert layer_lines[0] == layer_lines[1]
    assert len(layer_lines[1]) == len(ttr.layer_names(cfg))
    err = _number(r"total layer error (\S+)", jout)
    assert abs(res["total_error"] - err) <= 1e-5 * err
    jppl = [_number(rf"{k} (\d+\.\d+)", jout)
            for k in ("fp32", "quantized", "decode-scored")]
    tppl = [res["ppl"][k] for k in ("fp32", "quantized", "decode")]
    np.testing.assert_allclose(tppl, jppl, rtol=1e-5)
    assert not res["ppl"]["warned"] and "WARNING" not in jout + tout


def test_serve_cli_nf4_matches_jax(runs):
    """``serve_cli`` of both packages on the port's NF4 checkpoint at f32
    (every linear 'plane': K8f's plain version in the port, the XLA route
    in JAX): equal greedy tokens, request by request, cold and steady."""
    ckpt = str(runs["root"] / "port_nf4")
    jout, _ = run_main(js_cli.main, [ckpt] + SERVE_ARGS)
    tout, res = run_main(ts_cli.main, [ckpt] + SERVE_ARGS
                         + ["--device", "cpu"])
    line = re.compile(r"^\[(\d+)\] \+(\d+) tokens \((\w+)\): (\[.*\])$", re.M)
    want, got = line.findall(jout), line.findall(tout)
    assert len(want) == len(got) == 4
    assert got == want
    assert [c.new_tokens.tolist() for c in res["steady"]] == [
        c.new_tokens.tolist() for c in res["cold"]]
