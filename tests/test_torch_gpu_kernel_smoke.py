"""``tools/gpu_kernel_smoke.py`` on the CPU (``--quick --device cpu``, its
geometries shrunk): every case runs through the kernel wrappers (their
plain versions on the CPU) and holds against the dense f32 oracle; its
rows are named case for case as ``TPU_KERNEL_SMOKE.json``'s, less the
stated absence and plus the stated additions; a failing case fails the
tool. On the card the same tool launches the kernels."""

import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def tool(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "gpu_kernel_smoke", ROOT / "tools" / "gpu_kernel_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # K a multiple of pair3x's 512-row group, as every geometry is.
    monkeypatch.setattr(mod, "GEOMS", (("opt1.3b-fc1", 512, 256),
                                       ("opt1.3b-attn", 512, 128)))
    monkeypatch.setattr(mod, "NF4_SHAPE", (256, 128))
    monkeypatch.setattr(mod, "PREFILL_CASES", {
        "mha": (2, 2, 64, 64, 1, False), "gqa": (1, 2, 64, 128, 4, False),
        "alibi": (1, 2, 64, 64, 1, True)})
    return mod


def _tpu_names():
    with open(ROOT / "TPU_KERNEL_SMOKE.json") as f:
        return [r["case"] for r in json.load(f)["results"]]


def test_quick_cpu_rows_and_names(tool, tmp_path, capsys):
    out = tmp_path / "smoke.json"
    assert tool.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    summary = json.loads(out.read_text())
    rows = summary["results"]
    names = [r["case"] for r in rows]
    tpu = _tpu_names()
    assert summary["cases"] == len(rows) == summary["ok"]
    assert summary["failed"] == [] and summary["backend"] == "cpu"
    assert {"name", "power_limit", "slowest"} <= set(summary)
    assert len(set(names)) == len(names)
    # Every row a TPU case or a stated addition; every TPU case of the
    # quick geometries present, but the stated absence.
    assert [n for n in names if n not in tpu
            and not tool.added_name(n, set(tpu))] == []
    quick = [n for n in tpu if "llama8b" not in n]
    assert sorted(set(quick) - set(names)) == [
        "dequant_matmul/nf4/plane-stacked"]
    for n in quick:
        if n.startswith("dequant_matmul/") and n in names:
            assert f"{n}/m64" in names
    f32 = [n for n in names if "-f32" in n]
    assert sorted(f32) == sorted(
        [f"{n}-f32{m}" for n in tpu if n.endswith("/plane")
         and "llama8b" not in n for m in ("", "/m64")]
        + [f"flash_prefill/{t}-f32" for t in ("mha", "gqa", "alibi")])
    assert "flash_decode/mha32/ew" in names
    for r in rows:
        assert r["ok"] and r["kernels"] == [] and r["secs"] >= 0
        if not r["case"].startswith(("kv_append", "paged_kv_append")):
            assert r["max_rel_err"] < tool.ORACLE_TOL
        assert r["plain_tol"] in ("bf16", "ulp", "f32", "f32_elem", "exact")
    assert f"{len(rows)}/{len(rows)} kernel cases OK" in capsys.readouterr(
        ).out


def test_a_failing_case_fails_the_tool(tool, tmp_path, monkeypatch):
    """A kernel entry whose answer is off fails its cases and the tool (exit
    1), with the failures listed."""
    from sleekit_tpu_torch.ops import attention as at

    good = at.flash_prefill
    monkeypatch.setattr(at, "flash_prefill",
                        lambda *a: good(*a) * 1.1)
    monkeypatch.setattr(tool, "GEOMS", tool.GEOMS[1:])
    out = tmp_path / "smoke.json"
    assert tool.main(["--quick", "--device", "cpu", "--out", str(out)]) == 1
    summary = json.loads(out.read_text())
    assert summary["failed"] == [f"flash_prefill/{t}{s}"
                                 for t in ("mha", "gqa", "alibi")
                                 for s in ("", "-f32")]


@pytest.mark.parametrize("name,added", [
    ("dequant_matmul/opt1.3b-fc1/int4/pair/m64", True),
    ("dequant_matmul/opt1.3b-fc1/int4/pair+ln/m64", True),
    ("dequant_matmul/nf4/plane-f32/m64", True),
    ("flash_prefill/gqa-f32", True),
    ("flash_decode/mha32/ew", True),
    ("dequant_matmul/opt1.3b-fc1/int4/pair-f32", False),
    ("flash_decode/mha32/dot-f32", False),
    ("kv_append/mha32/int8/m64", False),
    ("dequant_matmul/nf4/plane-stacked", False)])
def test_added_names(tool, name, added):
    assert tool.added_name(name, set(_tpu_names())) is added
