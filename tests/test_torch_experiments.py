"""The port's benches and its profiling helpers
(``sleekit_tpu_torch/experiments/{attn_bench,profile_decode,kernel_bench,
prefill_bench}`` and ``utils/profiling.py``), run on the CPU at the tiny
geometry: their
command lines parse, every variant runs the plain versions, and they print
and return their result structures. Times from these runs are the CPU's
and test nothing. On the card the same entry points time the kernels."""

import ast
import json

import pytest
import torch

from sleekit_tpu_torch.experiments import (
    attn_bench, kernel_bench, prefill_bench, profile_decode)
from sleekit_tpu_torch.ops import attention as tattn
from sleekit_tpu_torch.utils.profiling import (
    Timer, device_trace, time_ms)


def _printed(out: str):
    """The result line a bench printed last on stdout, parsed."""
    return ast.literal_eval(out.strip().splitlines()[-1])


@pytest.mark.parametrize("knobs,kernel", [
    ({}, "K11"), ({"FLASH_MHA_MODE": "ew"}, "K12"),
    ({"FLASH_BATCH_FOLD": True}, "K13")])
@pytest.mark.parametrize("kv,parts", [("int8", "both"), ("bf16", "decode")])
def test_attn_bench_runs_on_cpu(monkeypatch, capsys, knobs, kernel, kv,
                                parts):
    """attn_bench times one step over all layers and reports ms per step,
    us per layer and the effective rate; it reads the module knobs, and
    names the flash-decode kernel they select."""
    for name, value in knobs.items():
        monkeypatch.setattr(tattn, name, value)
    out = attn_bench.main(["--model", "tiny", "--batch", "2", "--ctx", "16",
                           "--kv", kv, "--iters", "2", "--parts", parts,
                           "--device", "cpu"])
    assert out["kernel"] == kernel and out["ms_per_step"] > 0
    assert out["us_per_layer"] == pytest.approx(out["ms_per_step"] / 2 * 1e3)
    printed = capsys.readouterr()
    assert _printed(printed.out) == out
    assert f"flash decode {kernel};" in printed.err


@pytest.mark.parametrize("extra", [[], ["--layout", "plane", "--kv", "bf16"],
                                   ["--dense", "--no-fuse"],
                                   ["--layout", "plane", "--codebook", "nf4"]])
def test_profile_decode_runs_on_cpu(capsys, extra):
    """Every variant runs; unembed and residual are derived from them."""
    out = profile_decode.main(["--model", "tiny", "--batch", "2", "--steps",
                               "2", "--ctx", "8", "--device", "cpu"] + extra)
    ms = out["ms_per_step"]
    assert set(ms) == {"full", "no_unembed", "linears_only", "attn_only",
                       "unembed", "residual"}
    assert ms["unembed"] == ms["full"] - ms["no_unembed"]
    assert ms["residual"] == (ms["no_unembed"] - ms["linears_only"]
                              - ms["attn_only"])
    assert out["eager_ms_per_step"] == {}  # eager device time: card only
    assert _printed(capsys.readouterr().out) == out


def test_profile_decode_variants_call_the_kernel_wrappers(monkeypatch):
    """linears_only and no_unembed go through the kernel wrappers (K1 for
    'pair' weights; on CPU tensors they take the plain versions), four
    projections a layer, as the decode step does."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm

    calls = []
    pair = dm.pair_matmul

    def spy(*a, **kw):
        calls.append(kw.get("pre"))
        return pair(*a, **kw)

    monkeypatch.setattr(dm, "pair_matmul", spy)
    for variant, pre in (("linears_only", {None}),
                         ("no_unembed", {None, "layernorm", "relu"})):
        calls.clear()
        profile_decode.main(["--model", "tiny", "--batch", "2", "--steps",
                             "2", "--ctx", "8", "--variants", variant,
                             "--device", "cpu"])
        # (1 warm-up + 2 timed steps) x 2 layers x 4 projections
        assert len(calls) == 24 and set(calls) == pre, (variant, calls)


def test_profile_decode_attn_only_follows_the_split_route(monkeypatch,
                                                          tmp_path, capsys):
    """attn_only goes through decode_attention, so the split route with
    the 'ew' knob runs K12's plain version; no params are built for it.
    --trace writes a Chrome trace of the full variant."""
    calls = []
    plain = tattn.flash_decode_ew_plain

    def spy(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(tattn, "flash_decode_ew_plain", spy)
    monkeypatch.setattr(tattn, "FLASH_FUSED_APPEND", False)
    monkeypatch.setattr(tattn, "FLASH_MHA_MODE", "ew")
    out = profile_decode.main(["--model", "tiny", "--batch", "2", "--steps",
                               "2", "--ctx", "8", "--variants", "attn_only",
                               "--device", "cpu"])
    assert set(out["ms_per_step"]) == {"attn_only"}
    # (1 warm-up + 2 timed steps) x 2 layers
    assert len(calls) == 6
    profile_decode.main(["--model", "tiny", "--batch", "1", "--steps", "1",
                         "--ctx", "4", "--variants", "full", "--device",
                         "cpu", "--trace", str(tmp_path)])
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    with pytest.raises(ValueError, match="--steps"):
        profile_decode.main(["--model", "tiny", "--steps", "9", "--ctx", "8",
                             "--device", "cpu"])


def test_profile_decode_steps_end_at_ctx(monkeypatch):
    """The steps run at the last --steps positions of the --ctx cache, so
    attention reads as many rows as a served step at that context."""
    seen = []
    real = tattn.decode_attention

    def spy(q, k, v, ck, cv, pos, layer, **kw):
        if layer == 0:
            seen.append(pos)
        return real(q, k, v, ck, cv, pos, layer, **kw)

    monkeypatch.setattr(tattn, "decode_attention", spy)
    out = profile_decode.main(["--model", "tiny", "--batch", "1", "--steps",
                               "3", "--ctx", "8", "--variants", "attn_only",
                               "--device", "cpu"])
    # one warm-up step, then the three timed ones
    assert seen == [5, 5, 6, 7]
    assert out["positions"] == [5, 7]


def test_profile_decode_flags_a_negative_residual(monkeypatch, capsys):
    """A residual below zero (the variants timed different work) is
    logged as a warning."""
    from sleekit_tpu_torch.utils import profiling

    times = iter([1.0, 3.0, 2.0])   # no_unembed, linears_only, attn_only
    monkeypatch.setattr(profiling, "time_ms", lambda *a, **kw: next(times))
    out = profile_decode.main(["--model", "tiny", "--batch", "1", "--steps",
                               "1", "--ctx", "4", "--variants",
                               "no_unembed,linears_only,attn_only",
                               "--device", "cpu"])
    assert out["ms_per_step"]["residual"] == -4.0
    assert "WARNING: the residual is negative" in capsys.readouterr().err


def test_kernel_bench_runs_on_cpu(capsys):
    """kernel_bench times pair, plane and dense per shape and reports the
    packed words' bytes per call; it refuses the TPU tuning variants."""
    out = kernel_bench.main(["--shapes", "256x64,512x32", "--iters", "1",
                             "--device", "cpu"])
    assert [(s, v) for s, v, _, _ in out] == [
        (s, v) for s in ("256x64", "512x32")
        for v in ("pair", "plane", "dense")]
    assert all(us > 0 and gbs >= 0 for _, _, us, gbs in out)
    assert _printed(capsys.readouterr().out) == out
    with pytest.raises(ValueError, match="pair@"):
        kernel_bench.main(["--variants", "pair@kb2s1d1", "--device", "cpu"])


def test_kernel_bench_int8_variant_times_k2(monkeypatch, capsys):
    """kernel_bench's int8 variant takes K2 (its plain version on the
    CPU) over a head packed with an 8-bit codebook, whatever --nbits
    says, and counts the padded int8 bytes (N 300 -> 1024)."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm

    calls = []
    real = dm.int8_matmul_plain

    def spy(x, packed, *a, **kw):
        calls.append(tuple(packed.shape))
        return real(x, packed, *a, **kw)

    monkeypatch.setattr(dm, "int8_matmul_plain", spy)
    out = kernel_bench.main(["--shapes", "256x300", "--variants", "int8",
                             "--nbits", "4", "--iters", "1", "--m", "20",
                             "--device", "cpu"])
    assert calls and set(calls) == {(256, 1024)}
    ((shape, variant, us, gbs),) = out
    assert (shape, variant) == ("256x300", "int8") and us > 0
    # us and GB/s are printed to one decimal
    assert gbs == pytest.approx(256 * 1024 / (us * 1e-6) / 1e9, abs=0.06)
    assert _printed(capsys.readouterr().out) == out


@pytest.mark.parametrize("layout,kernel", [("pair", "pair_matmul"),
                                           ("pair3", "pair3_matmul")])
def test_prefill_bench_runs_on_cpu(monkeypatch, capsys, tmp_path, layout,
                                   kernel):
    """prefill_bench times a full-depth prefill of batch x seq tokens
    through the kernel wrappers (at M = batch * seq, four linears a layer;
    plain versions on the CPU), reports tokens/s, and writes a trace."""
    from sleekit_tpu_torch.ops import dequant_matmul as dm

    rows = []
    inner = getattr(dm, kernel)
    monkeypatch.setattr(dm, kernel, lambda x, *a, **k: rows.append(
        x.shape[0]) or inner(x, *a, **k))
    out = prefill_bench.main(["--model", "tiny", "--batch", "2", "--seq",
                              "16", "--reps", "1", "--layout", layout,
                              "--device", "cpu", "--skip-matmul", "--trace",
                              str(tmp_path / "t")])
    assert out["tokens"] == 32 and out["ms"] > 0
    assert out["tokens_per_s"] == pytest.approx(32 / out["ms"] * 1e3)
    assert rows and set(rows) == {32} and len(rows) % 4 == 0
    assert (tmp_path / "t" / "trace.json").exists()
    assert _printed(capsys.readouterr().out) == out


def test_prefill_bench_large_logits_reads_k4_f32(monkeypatch, capsys):
    """prefill_bench --large-logits reads K4's f32 route in each case of
    K4_LARGE_CASES: its distances over the 1e-5 gate from its plain version
    and from the exact answer. On the CPU the route is the plain version
    itself, and at mean 1 f32 lies within the gate of the exact answer."""
    monkeypatch.setattr(prefill_bench, "K4_LARGE_CASES",
                        ((16, 1.0), (16, 3.0)))
    out = prefill_bench.main(["--large-logits", "--device", "cpu"])
    rows = out["large_logits"]
    assert [(r["D"], r["mean"]) for r in rows] == [(16, 1.0), (16, 3.0)]
    assert all(r["kernel_plain"] == 0.0
               and r["kernel_exact"] == r["plain_exact"] for r in rows)
    assert 0.0 < rows[0]["plain_exact"] <= 1.0
    assert _printed(capsys.readouterr().out) == out


def test_prefill_bench_attention_times_k4(monkeypatch, capsys):
    """prefill_bench --attention times flash_prefill alone in each case,
    with the model's geometry (ALiBi slopes for BLOOM, KV heads for GQA),
    in bf16 or, with --dtype f32, in f32."""
    calls, dtypes = [], []
    inner = tattn.flash_prefill

    def spy(q, k, v, scale, slopes=None):
        calls.append((tuple(q.shape), k.shape[1], slopes is not None))
        dtypes.append(q.dtype)
        return inner(q, k, v, scale, slopes)

    monkeypatch.setattr(tattn, "flash_prefill", spy)
    monkeypatch.setattr(prefill_bench, "K4_CASES", (
        ("tiny", 2, 16), ("bloom-560m", 1, 8), ("llama3-8b", 1, 8)))
    out = prefill_bench.main(["--attention", "--reps", "1", "--device",
                              "cpu"])
    assert [r["case"] for r in out["attention"]] == [
        "tiny B=2 T=16", "bloom-560m B=1 T=8", "llama3-8b B=1 T=8"]
    assert all(r["ms"] > 0 for r in out["attention"])
    assert set(calls) == {((2, 16, 4, 16), 4, False),
                          ((1, 8, 16, 64), 16, True),
                          ((1, 8, 32, 128), 8, False)}
    assert _printed(capsys.readouterr().out) == out
    calls.clear()
    out = prefill_bench.main(["--attention", "--models", "llama3-8b",
                              "--reps", "1", "--device", "cpu"])
    assert [r["case"] for r in out["attention"]] == ["llama3-8b B=1 T=8"]
    assert set(calls) == {((1, 8, 32, 128), 8, False)}
    calls.clear()
    out = prefill_bench.main(["--attention", "--models", "llama3-8b",
                              "--dtype", "f32", "--reps", "1", "--device",
                              "cpu"])
    assert [r["dtype"] for r in out["attention"]] == ["float32"]
    assert set(calls) == {((1, 8, 32, 128), 8, False)}
    assert dtypes[-1] == torch.float32 and dtypes[0] == torch.bfloat16


def test_prefill_bench_kv_write_times_k10(monkeypatch, capsys):
    """prefill_bench --kv-write times K10 over a prompt's rows (kernel and
    plain version, K/V sliced out of a fused qkv output) and at one row a
    (batch row, head), with K14 where the case asks for it."""
    calls = []
    inner = tattn.kv_prefill_write

    def spy(k, v, *args):
        calls.append((tuple(k.shape), k.is_contiguous()))
        return inner(k, v, *args)

    monkeypatch.setattr(tattn, "kv_prefill_write", spy)
    monkeypatch.setattr(prefill_bench, "K10_PREFILL_CASES", (
        ("prefill tiny", 2, 16, 4, 2, 16),))
    monkeypatch.setattr(prefill_bench, "K10_APPEND_CASES", (
        ("T=1 B=2 KV=2", 2, 2, (5, 9), True), ("T=1 B=1 KV=1", 1, 1, (5,),
                                              False)))
    monkeypatch.setattr(prefill_bench, "APPEND_LAYERS", 2)
    monkeypatch.setattr(prefill_bench, "APPEND_ROWS", 32)
    monkeypatch.setattr(prefill_bench, "APPEND_PAGE", 8)
    out = prefill_bench.main(["--kv-write", "--reps", "1", "--device",
                              "cpu"])
    assert [r["case"] for r in out["kv_write"]] == [
        "K10 prefill tiny kernel", "K10 prefill tiny plain",
        "K10 T=1 B=2 KV=2 pos 5", "K14 T=1 B=2 KV=2 pos 5",
        "K10 T=1 B=2 KV=2 pos 9", "K14 T=1 B=2 KV=2 pos 9",
        "K10 T=1 B=1 KV=1 pos 5"]
    assert all(r["ms"] > 0 for r in out["kv_write"])
    assert calls and set(calls) == {((2, 16, 2, 16), False)}
    assert _printed(capsys.readouterr().out) == out


def test_prefill_bench_trace_counts_the_quantizer(tmp_path):
    """prefill_bench --trace returns the trace's device time by kernel
    (none on the CPU) and the int8 KV quantizer's op calls: on the CPU
    the plain KV write runs them, once for K and once for V a layer."""
    from sleekit_tpu_torch.models.zoo import get_config

    out = prefill_bench.main(["--model", "tiny", "--batch", "2", "--seq",
                              "16", "--reps", "1", "--device", "cpu",
                              "--skip-matmul", "--trace",
                              str(tmp_path / "t")])
    n = get_config("tiny").n_layers
    assert out["trace"]["device_ms"] == 0 and out["trace"]["kernels"] == []
    assert out["trace"]["quant_ops"] == {"aten::round": 2 * n,
                                         "aten::amax": 2 * n}


def test_timer_sections_and_counts():
    """Sections accumulate time and counts; timed() waits for a value's
    device and returns it; the report orders sections by total time."""
    timer = Timer()
    for _ in range(3):
        with timer.section("loop"):
            sum(range(20000))
    with timer.section("once"):
        pass
    x = torch.ones(4)
    assert timer.timed("value", {"a": [x, (x, 1)]}) == {"a": [x, (x, 1)]}
    report = timer.report()
    assert {k: v["count"] for k, v in report.items()} == {
        "loop": 3, "once": 1, "value": 1}
    assert list(report)[0] == "loop"
    assert report["loop"]["mean_s"] == pytest.approx(
        report["loop"]["total_s"] / 3, abs=1e-4)
    assert json.loads(timer.dump()) == report


def test_time_ms_and_device_trace_on_cpu(tmp_path):
    """On the CPU time_ms takes the host clock over the calls after one
    warm-up; device_trace writes trace.json and yields the profiler."""
    seen = []
    ms = time_ms(seen.append, 3, torch.device("cpu"), iters=5)
    assert seen == [0, 0, 1, 2, 0, 1] and ms >= 0
    with device_trace(str(tmp_path / "t")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "t" / "trace.json").exists()
    assert any("matmul" in e.key or "dot" in e.key
               for e in prof.key_averages())
