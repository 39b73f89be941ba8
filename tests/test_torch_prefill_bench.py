"""``prefill_bench``'s matmul section and its attention-route A/B
(``--modes``, ``models/transformer.py`` ``PREFILL_MODE``) on the CPU at tiny
shapes: the three forms of ``x @ deq(W)`` agree within the bf16 tolerance,
'pair' goes through the K1/K7 wrappers, the crossover and MFU fields; the
'xla' route's prefill equals the JAX package's (which takes its XLA route
on the CPU), 'stock' raises, and the global is put back whatever happens.
Times from these runs are the CPU's and test nothing."""

import ast

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sleekit_tpu.models import transformer as jtr
from sleekit_tpu_torch.experiments import prefill_bench
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models import zoo
from sleekit_tpu_torch.ops import dequant_matmul as dm

from tests._torch_port_util import f32
from tests.test_torch_model import _models

# Small geometries: K a multiple of pair3's 256-row tile.
GEOMS = (("fc1", 256, 384), ("attn-qkv", 512, 128))


def _printed(out: str):
    return ast.literal_eval(out.strip().splitlines()[-1])


@pytest.fixture
def tiny512(monkeypatch):
    """The zoo's 'tiny' with 512 positions, so a 256-token prompt takes
    K4's route."""
    monkeypatch.setitem(zoo.ZOO, "tiny",
                        lambda **kw: zoo.tiny_test(max_seq_len=512, **kw))


def test_matmul_section_runs_on_cpu(monkeypatch, capsys):
    """Every (geometry, bits, M) row times the three forms; 'pair' runs the
    K1 ('pair', int4) or K7 ('pair3', int3) wrapper at each M, every form
    is within the bf16 tolerance of the f32 product, there is no MFU on
    the CPU, and the crossover is the first M where deq+mm wins."""
    monkeypatch.setattr(prefill_bench, "MATMUL_GEOMS", GEOMS)
    monkeypatch.setattr(prefill_bench, "MATMUL_MS", (8, 24))
    calls = []
    for name in ("pair_matmul", "pair3_matmul"):
        inner = getattr(dm, name)
        monkeypatch.setattr(dm, name, lambda x, *a, _n=name, _i=inner, **k:
                            calls.append((_n, x.shape[0])) or _i(x, *a, **k))
    out = prefill_bench.main(["--model", "tiny", "--batch", "2", "--seq",
                              "16", "--reps", "1", "--device", "cpu"])
    rows = out["matmul"]
    assert [(r["geom"], r["nbits"], r["layout"], r["M"]) for r in rows] == [
        (g, b, lay, m) for g, _, _ in GEOMS
        for b, lay in ((3, "pair3"), (4, "pair")) for m in (8, 24)]
    for r in rows:
        assert set(r["within"]) == set(prefill_bench.MATMUL_FORMS)
        assert all(r["within"].values()), r
        assert r["mfu"] is None
        assert all(r[f"{f}_ms"] > 0 for f in prefill_bench.MATMUL_FORMS)
    # The section's pair calls, then the end-to-end prefill's (M = 32).
    section = [c for c in calls if c[1] != 32]
    assert {c for c in section} == {("pair3_matmul", 8), ("pair3_matmul", 24),
                                    ("pair_matmul", 8), ("pair_matmul", 24)}
    assert set(out["crossover"]) == {"fc1/int3", "fc1/int4",
                                     "attn-qkv/int3", "attn-qkv/int4"}
    for key, m in out["crossover"].items():
        g, b = key.split("/int")
        ms = [r for r in rows if r["geom"] == g and r["nbits"] == int(b)]
        wins = [r["M"] for r in ms if r["deq+mm_ms"] < r["pair_ms"]]
        assert m == (wins[0] if wins else None)
    assert _printed(capsys.readouterr().out) == out


@pytest.mark.parametrize("layout,nbits", [("pair", 4), ("pair3", 3),
                                          ("pair", 2)])
def test_forms_agree(layout, nbits):
    """pair, deq+mm and dense on one weight: each within the bf16 tolerance
    of the others (and of the f32 product)."""
    from sleekit_tpu_torch.codebooks import UniformCodebook
    from sleekit_tpu_torch.models.fake_quant import random_packed_linear

    w = random_packed_linear(0, 512, 96, UniformCodebook(2 ** nbits, -1, 1),
                             layout=layout, device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (40, 512), np.float32) * 0.1).bfloat16()
    forms = {"pair": dm.quantized_matmul(x, w),
             "deq+mm": prefill_bench.dequant_dense_bf16(x, w),
             "dense": torch.matmul(x, w.dequantize().bfloat16())}
    assert all(y.dtype == torch.bfloat16 and y.shape == (40, 96)
               for y in forms.values())
    ref = x.float() @ w.dequantize()
    for a in forms.values():
        assert prefill_bench.bf16_distance(a, ref)[1]
        for b in forms.values():
            assert prefill_bench.bf16_distance(a, b)[1]
    off = forms["pair"] + 0.1 * ref.abs().max()
    assert not prefill_bench.bf16_distance(off, ref)[1]


def test_skip_matmul(capsys):
    out = prefill_bench.main(["--model", "tiny", "--batch", "1", "--seq",
                              "8", "--reps", "1", "--device", "cpu",
                              "--skip-matmul"])
    assert "matmul" not in out and "crossover" not in out
    assert "modes" not in out and out["ms"] > 0


def test_modes_ours_and_xla(monkeypatch, tiny512, capsys):
    """--modes ours,xla times one prefill a mode: 'ours' sends the 256-token
    prompt to K4 (its plain version here), 'xla' never; the xla logits
    within a relative L2 of 2^-6 of ours'; the global is 'ours' after."""
    seen = []
    inner = ttr.flash_prefill
    monkeypatch.setattr(ttr, "flash_prefill",
                        lambda *a: seen.append(ttr.PREFILL_MODE) or inner(*a))
    out = prefill_bench.main(["--model", "tiny", "--batch", "2", "--seq",
                              "256", "--reps", "1", "--device", "cpu",
                              "--skip-matmul", "--modes", "ours,xla"])
    modes = out["modes"]
    assert list(modes) == ["ours", "xla"]
    assert modes["ours"]["rel_l2"] == 0.0
    assert 0.0 < modes["xla"]["rel_l2"] <= 2 ** -6
    assert out["ms"] == modes["ours"]["ms"]
    assert modes["xla"]["tokens_per_s"] == pytest.approx(
        512 / modes["xla"]["ms"] * 1e3)
    assert seen and set(seen) == {"ours"}
    assert ttr.PREFILL_MODE == "ours"
    assert _printed(capsys.readouterr().out) == out


def test_stock_raises_and_the_global_comes_back(tiny512):
    """'stock' (and any unknown mode) raises ValueError naming the missing
    route; after a failing mode PREFILL_MODE is what it was."""
    with pytest.raises(ValueError, match="'stock' prefill route"):
        prefill_bench.main(["--model", "tiny", "--batch", "1", "--seq",
                            "256", "--reps", "1", "--device", "cpu",
                            "--skip-matmul", "--modes", "ours,stock"])
    assert ttr.PREFILL_MODE == "ours"
    with pytest.raises(ZeroDivisionError):
        with prefill_bench.prefill_mode("xla"):
            assert ttr.PREFILL_MODE == "xla"
            raise ZeroDivisionError
    assert ttr.PREFILL_MODE == "ours"
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 4, 8, 16)
    for mode in ("stock", "flash"):
        with prefill_bench.prefill_mode(mode), pytest.raises(
                ValueError, match="PREFILL_MODE"):
            ttr._causal_attention(zoo.tiny_test(), q, kv, kv,
                                  torch.arange(8)[None])
    assert ttr.PREFILL_MODE == "ours"


@pytest.mark.parametrize("family", ["opt", "bloom", "llama"])
def test_xla_mode_prefill_matches_jax(monkeypatch, family):
    """PREFILL_MODE 'xla': the port's prefill of a 256-token prompt takes
    ``_attention`` (no K4, plain or not) and its logits equal the JAX
    package's (XLA's route on the CPU) within the f32 model tolerance,
    1e-4; 'ours' (K4's plain version) does too."""
    jcfg, jp, tcfg, tp = _models(family, max_seq_len=512)
    tokens = np.random.RandomState(5).randint(0, 256, (2, 256)).astype(
        np.int32)
    cache = jtr.init_kv_cache(jcfg, 2, 256)
    want = np.asarray(jtr.prefill(jcfg, jp, jnp.asarray(tokens), cache)[0],
                      np.float32)
    calls = []
    inner = ttr.flash_prefill_plain
    monkeypatch.setattr(ttr, "flash_prefill_plain",
                        lambda *a: calls.append(1) or inner(*a))
    for mode, k4 in (("xla", 0), ("ours", tcfg.n_layers)):
        calls.clear()
        with prefill_bench.prefill_mode(mode):
            cache = ttr.init_kv_cache(tcfg, 2, 256, torch.float32,
                                      device="cpu")
            got = f32(ttr.prefill(tcfg, tp, torch.from_numpy(tokens),
                                  cache)[0])
        assert len(calls) == k4
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert ttr.PREFILL_MODE == "ours"

