"""The quantize command in the port against the JAX package's:
``quantize_model_cli`` from a tiny HF-layout OPT checkpoint (safetensors)
writes the same packed words, scales, meta and total error, and scores the
same perplexities; the spill and drain branches write the same words; the
device-memory decisions (spill, offload plan, shed list) on given sizes
against values worked out by hand from the JAX package's formulas; and
the background drain never puts back an entry that the solve loop has
freed. ``serve_cli``: tests/test_torch_serve_cli.py."""

import re
import threading
import time

import numpy as np
import pytest
import torch

from sleekit_tpu.experiments import quantize_model_cli as jq_cli
from sleekit_tpu_torch.experiments import quantize_model_cli as tq_cli
from sleekit_tpu_torch.experiments.quantize_model_cli import (
    StatsTable, drain, est_stats_bytes, offload_plan, solve_workspace,
    spill_needed, tree_bytes)
from sleekit_tpu_torch.models import quantize as tq
from sleekit_tpu_torch.models import transformer as ttr
from sleekit_tpu_torch.models import zoo as tzoo
from sleekit_tpu_torch.models.data import calibration_batches, synthetic_stream
from sleekit_tpu_torch.serve.checkpoint import load_packed_params

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    TINY_OPT, one_torch_thread, run_main, tiny_opt_checkpoint)

NAME = TINY_OPT
QUANT_ARGS = ["--model", NAME, "--samples", "16", "--seq-len", "32",
              "--batch", "32", "--preset", "light", "--nbits", "4",
              "--eval-ppl"]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The tiny OPT's HF checkpoint and one quantize run of each package
    on it."""
    root = tmp_path_factory.mktemp("cli")
    with tiny_opt_checkpoint(root) as hf:
        argv = QUANT_ARGS + ["--checkpoint", str(hf)]
        jout, _ = run_main(jq_cli.main, [str(root / "jax")] + argv)
        tout, result = run_main(tq_cli.main, [str(root / "port")] + argv
                                + ["--device", "cpu"])
        yield dict(root=root, jout=jout, tout=tout, result=result)


def _number(pattern, text):
    return float(re.search(pattern, text).group(1))


def test_quantize_cli_matches_jax(runs):
    """The same packed words (bit for bit), scales within 1e-6, meta and
    per-layer report order; total error within 1e-5 relative and the
    perplexities (fp32, quantized, decode-scored) within 1e-5 relative;
    every statistics entry freed."""
    root, jout, tout, res = (runs[k] for k in ("root", "jout", "tout",
                                               "result"))
    cfg = tzoo.tiny_test()
    tparams, tmeta = load_packed_params(str(root / "port"), device="cpu")
    jparams, jmeta = load_packed_params(str(root / "jax"), device="cpu")
    assert tmeta == jmeta == {"model": NAME, "preset": "light", "nbits": 4,
                              "codebook": "uniform"}
    for name in ttr.layer_names(cfg):
        got = ttr.get_linear_param(tparams, name)
        want = ttr.get_linear_param(jparams, name)
        assert (got.layout, got.nbits) == (want.layout, want.nbits) == (
            "pair", 4)
        assert torch.equal(got.packed, want.packed), name
        np.testing.assert_allclose(got.scale.numpy(), want.scale.numpy(),
                                   rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.bias.numpy(), want.bias.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    layer_lines = [re.findall(r"^  (layers\.\S+)\s+err=", out, re.M)
                   for out in (jout, tout)]
    assert layer_lines[0] == layer_lines[1]
    assert len(layer_lines[1]) == len(ttr.layer_names(cfg))
    assert "calibration tokens: synthetic" in tout
    err = _number(r"total layer error (\S+)", jout)
    assert abs(res["total_error"] - err) <= 1e-5 * err
    assert _number(r"total layer error (\S+)", tout) == pytest.approx(
        res["total_error"], rel=1e-5)
    jppl = [_number(rf"{k} (\d+\.\d+)", jout)
            for k in ("fp32", "quantized", "decode-scored")]
    tppl = [res["ppl"][k] for k in ("fp32", "quantized", "decode")]
    np.testing.assert_allclose(tppl, jppl, rtol=1e-5)
    assert not res["ppl"]["warned"] and "WARNING" not in jout + tout
    assert res["stats_left"] == [] and not res["spill"]
    assert set(res["timer"]) == {"calibrate", "quantize", "save", "eval_ppl"}
    assert f"checkpoint -> {root / 'port'}" in tout


@pytest.mark.parametrize("branch", ["spill", "drain"])
def test_spill_and_drain_branches_write_the_same_words(runs, branch,
                                                       monkeypatch):
    """The memory branches through ``main`` on the CPU, driven by a
    ``QUANT_HBM_LIMIT`` from the CLI's own estimates: spilling
    (``calibrate_spill``, host statistics, packing on the host) or
    shedding every entry to the background drain under the solves (the
    calibration headroom set to 0, since a tiny model's statistics sit far
    below the JAX package's fixed headroom). The packed words, scales and
    biases are the plain run's, bit for bit, and no statistics entry is
    left; the spill run's packed params, moved from the host for
    ``--eval-ppl``, score the plain run's perplexities."""
    from sleekit_tpu_torch.models.hf import load_hf_checkpoint

    root, cfg = runs["root"], tzoo.tiny_test()
    p_bytes = tree_bytes(load_hf_checkpoint(cfg, NAME, str(root / "hf"),
                                            device="cpu"))
    s_est = est_stats_bytes(cfg)
    if branch == "spill":
        limit = p_bytes + s_est + 1e9
    else:
        monkeypatch.setattr(tq_cli, "SPILL_HEADROOM", 0.0)
        entries = [(n, cfg.d_ff if n.endswith("fc2") else cfg.d_model, 0)
                   for n in ttr.layer_names(cfg)]
        limit = offload_plan(entries, p_bytes, 0, "never")["peak"] + s_est
    monkeypatch.setenv("QUANT_HBM_LIMIT", repr(limit))
    out = root / branch
    argv = QUANT_ARGS if branch == "spill" else QUANT_ARGS[:-1]
    _, res = run_main(tq_cli.main, [str(out)] + argv + [
        "--checkpoint", str(root / "hf"), "--device", "cpu"])
    assert res["spill"] == (branch == "spill")
    assert res["offload"] == ("none" if branch == "spill" else "shed")
    if branch == "drain":
        assert res["shed"] == sorted(
            ttr.layer_names(cfg),
            key=lambda n: (n.endswith("fc2"), ttr.layer_names(cfg).index(n)),
            reverse=True)
    assert res["stats_left"] == []
    if branch == "spill":
        assert res["ppl"] == runs["result"]["ppl"]
    want, _ = load_packed_params(str(root / "port"), device="cpu")
    got, _ = load_packed_params(str(out), device="cpu")
    for name in ttr.layer_names(cfg):
        g, w = (ttr.get_linear_param(t, name) for t in (got, want))
        for f in ("packed", "scale", "bias"):
            assert torch.equal(getattr(g, f), getattr(w, f)), (name, f)


# ---- the device-memory decisions --------------------------------------------


def test_spill_and_offload_decisions():
    """Worked by hand from the JAX package's formulas. Entries (name, K,
    bytes): two K = 1000 entries of 1 GB, two K = 4000 entries of 4 GB,
    params 2 GB. Workspaces: K = 1000 floors at 0.5 GB, K = 4000 is 3.5
    GB x (4000/8192)^2 = 0.834 GB. Smallest K first: 2 + 10 + 0.5 = 12.5
    GB, then 11.5, 10.834, 6.834: the peak is 12.5 GB."""
    entries = [("l0.q", 1000, 1e9), ("l0.fc2", 4000, 4e9),
               ("l1.q", 1000, 1e9), ("l1.fc2", 4000, 4e9)]
    assert solve_workspace(1000) == 0.5e9
    assert solve_workspace(4000) == pytest.approx(3.5e9 * (4000 / 8192) ** 2)
    assert solve_workspace(8192) == 3.5e9
    # Spill: params + statistics + 1.5 GB over the limit.
    assert spill_needed(2e9, 10e9, 13.4e9)
    assert not spill_needed(2e9, 10e9, 13.5e9)
    # auto, fits: peak + 0.5 GB margin = 13.0 GB <= 13.5 GB.
    plan = offload_plan(entries, 2e9, 13.5e9, "auto")
    assert plan["peak"] == pytest.approx(12.5e9)
    assert (plan["action"], plan["shed"]) == ("none", [])
    # auto, does not fit at 12.9 GB: shed largest first (the later of two
    # equal entries first) until 13.0 - shed + 2 x largest shed <= 12.9:
    # 4 GB: 17.0; 8 GB: 13.0; 9 GB: 12.0, stop.
    plan = offload_plan(entries, 2e9, 12.9e9, "auto")
    assert plan["action"] == "shed"
    assert plan["shed"] == ["l1.fc2", "l0.fc2", "l1.q"]
    assert plan["shed_bytes"] == pytest.approx(9e9)
    assert offload_plan(entries, 2e9, 100e9, "always")["action"] == "always"
    assert offload_plan(entries, 2e9, 1e9, "never")["action"] == "none"


def test_stats_size_estimate_matches_calibration():
    """The estimate (the JAX package's formula: 4 bytes x (K^2 + 2K) per
    linear) without allocating the statistics, against the calibrated
    tree's bytes (a K x K Hessian, a (K,) mean and a scalar count): one
    (K,) vector less a count apart per entry."""
    cfg = tzoo.tiny_test()
    params = ttr.init_params(cfg, 0, device="cpu")
    stats = tq.calibrate(cfg, params, calibration_batches(
        synthetic_stream(cfg.vocab_size, 64, 0), 2, 32))
    # tiny: 2 layers x (5 x 4(64^2 + 128) + 4(128^2 + 256)) bytes.
    assert est_stats_bytes(cfg) == 2 * (5 * 4 * 4224 + 4 * 16640)
    assert tree_bytes(stats) == est_stats_bytes(cfg) - sum(
        4 * (st.mean.numel() - 1) for st in stats.values())


# ---- the drain and the solve loop's pop -------------------------------------


@pytest.mark.parametrize("when", ["before_write_back", "during_write_back"])
def test_drain_never_reinserts_a_popped_entry(when):
    """The solve loop pops (frees) entry 'a' while the drain has it in
    flight: after its copy and before the write-back, or inside the
    write-back, after the drain found 'a' present (the unguarded
    check-then-set window). Either way 'a' stays freed; 'b' lands on the
    host."""
    in_copy, in_write, popping = (threading.Event() for _ in range(3))

    class Probe(StatsTable):
        def __setitem__(self, name, value):
            if name == "a":
                in_write.set()
                popping.wait(5)
                time.sleep(0.05)   # an unguarded pop would land here
            super().__setitem__(name, value)

    stats = Probe({"a": "device a", "b": "device b"})

    def to_host(st):
        in_copy.set()
        if when == "before_write_back" and st == "device a":
            popping.wait(5)
            time.sleep(0.05)
        return st.replace("device", "host")

    moved = []
    t = threading.Thread(target=lambda: moved.extend(
        drain(stats, ["a", "b"], to_host, group_bytes=float("inf"))))
    t.start()
    (in_copy if when == "before_write_back" else in_write).wait(5)
    popper = threading.Thread(target=lambda: (popping.set(),
                                              stats.pop("a", None)))
    popper.start()
    popper.join(5)
    t.join(5)
    assert not t.is_alive() and not popper.is_alive()
    assert dict(stats) == {"b": "host b"}
    assert moved == (["b"] if when == "before_write_back" else ["a", "b"])
