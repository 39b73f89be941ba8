"""The port's ablation CLIs against the JAX package's (mirrors
tests/test_experiments.py): the JAX package's ``dump_stats`` writes one
tiny directory; each analysis CLI runs through both packages' ``main``
with the JAX test's arguments on a sub-root of two of its layers (a
(64, 64) and a (64, 128) linear: the JAX CLIs recompile their loops at
every call and take about 35 s a layer here), with identical headers and
layer names and every value within rel 1e-3; ``results`` prints the JAX
package's text on the same TSVs; the port's ``dump_stats`` writes what
the port's ``calibrate`` gives, and the two packages' dumps load in each
other's ``load_layer``."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from sleekit_tpu.experiments import (
    bits as jbits, common as jcommon, compare as jcompare,
    correction as jcorrection, dampening as jdampening,
    distribution as jdistribution, dump_stats as jdump_stats,
    local_search as jlocal_search, ordering as jordering,
    results as jresults, scaling as jscaling)
from sleekit_tpu_torch.experiments import (
    bits, common, compare, correction, dampening, distribution, dump_stats,
    local_search, ordering, results, scaling)
from sleekit_tpu_torch.models.quantize import calibrate
from sleekit_tpu_torch.models.transformer import (
    get_linear_param, init_params, layer_names)
from sleekit_tpu_torch.models.zoo import tiny_test

from tests._torch_port_util import (  # noqa: F401 (a fixture)
    one_torch_thread, run_main)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DUMP = ["--model", "tiny", "--samples", "4", "--seq-len", "32"]
CB4 = ["--codebook-size", "4", "--grid-size", "10"]
# Each analysis CLI: (JAX module, port module, tests/test_experiments.py's
# arguments).
ANALYSES = {
    "compare": (jcompare, compare, CB4),
    "scaling": (jscaling, scaling, CB4 + ["--run-diag", "--run-hessian"]),
    "correction": (jcorrection, correction, CB4),
    "ordering": (jordering, ordering, CB4),
    "dampening": (jdampening, dampening, CB4),
    "local_search": (jlocal_search, local_search, CB4),
    "bits": (jbits, bits, ["--grid-size", "5"]),
}
PARITY_LAYERS = ("layers_0_q", "layers_0_fc2")


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jaxdump"))
    run_main(jdump_stats.main, [d] + DUMP)
    return d


@pytest.fixture(scope="module")
def sub_root(jax_dump, tmp_path_factory):
    """A root holding two of the JAX dump's layer directories."""
    d = tmp_path_factory.mktemp("parity")
    for name in PARITY_LAYERS:
        shutil.copytree(os.path.join(jax_dump, name), d / name)
    return str(d)


@pytest.fixture(scope="module")
def tables(sub_root):
    """Each analysis CLI's stdout, (JAX, port), run once."""
    return {name: (run_main(jmod.main, [sub_root] + argv)[0],
                   run_main(tmod.main, [sub_root] + argv
                            + ["--device", "cpu"])[0])
            for name, (jmod, tmod, argv) in ANALYSES.items()}


def _rows(text):
    return [line.split("\t") for line in text.strip().split("\n")]


@pytest.mark.parametrize("name", list(ANALYSES))
def test_analysis_cli_matches_jax(name, tables):
    """The same header, layer names and labels; every value finite and
    within rel 1e-3 of the JAX package's (the largest gap measured here:
    see CHANGES.md)."""
    want, got = (_rows(t) for t in tables[name])
    assert got[0] == want[0]
    assert [r[0] for r in got[1:]] == sorted(PARITY_LAYERS)
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for col, a, b in zip(want[0], g, w):
            try:
                b = float(b)
            except ValueError:
                assert a == b, col
                continue
            assert np.isfinite(float(a)) and float(a) == pytest.approx(
                b, rel=1e-3), (name, g[0], col)


def test_analysis_cli_gates(tables):
    """tests/test_experiments.py's gates on the port's tables: local
    search never raises the error, and the 5-bit standard error is below
    the 1-bit one."""
    for line in _rows(tables["local_search"][1])[1:]:
        _, _, e0, _, e100 = line
        assert float(e100) <= float(e0) * 1.001
    for line in _rows(tables["bits"][1])[1:]:
        vals = [float(x) for x in line[1:11]]
        assert vals[-1] < vals[0]


def test_distribution_matches_jax(sub_root, tmp_path, monkeypatch):
    """``--save-data`` writes the JAX package's values (rel 1e-3); with
    no matplotlib the plot is refused with the JAX package's message."""
    argv = [sub_root, "--scaling", "mse", "--grid-size", "5"]
    jdistribution.main(argv + ["--save-data", str(tmp_path / "j.npy")])
    distribution.main(argv + ["--save-data", str(tmp_path / "t.npy"),
                              "--device", "cpu"])
    want, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.ndim == 1 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=0)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out, _ = run_main(distribution.main, argv + ["--device", "cpu"])
    assert out.strip() == "matplotlib unavailable; use --save-data instead"


FAMILY_FILES = {"compare": "compare_3b.csv", "ordering": "ordering_3b.csv",
                "correction": "correction_3b.csv",
                "scaling": "scaling_3b.csv",
                "local_search": "local_search_2b.csv",
                "dampening": "dampening_3b.csv", "bits": "bits.csv"}


def test_results_matches_jax(tables, tmp_path, monkeypatch):
    """``results`` prints the JAX package's text on the port's TSVs: the
    generic summary of compare's, and the per-family export
    (``export_all_families``, ``--families``) over a directory of the
    tables under the reference's file names."""
    fam = tmp_path / "families"
    fam.mkdir()
    for name, fname in FAMILY_FILES.items():
        (fam / fname).write_text(tables[name][1])
    path = str(fam / "compare_3b.csv")
    want, _ = run_main(jresults.main, [path])
    got, _ = run_main(results.main, [path])
    assert got == want and "SleekitHeavy" in got
    want, _ = run_main(jresults.export_all_families, str(fam))
    got, _ = run_main(results.export_all_families, str(fam))
    assert got == want
    assert got.count("\n") == len(FAMILY_FILES)
    assert run_main(results.main, ["--families", str(fam)])[0] == want
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out, _ = run_main(results.main, [path, "--plot"])
    assert out.endswith("matplotlib unavailable; skipping plot\n")


def test_port_dump_stats_is_calibrate(tmp_path):
    """The port's ``dump_stats`` on the CPU: 12 layer directories of four
    files, each array the port's ``calibrate`` on ``init_params(seed 0)``
    and the same random tokens, bit for bit."""
    d = tmp_path / "port"
    out, _ = run_main(dump_stats.main, [str(d)] + DUMP + ["--device", "cpu"])
    assert out.strip() == f"dumped 12 layers to {d}"
    cfg = tiny_test()
    params = init_params(cfg, seed=0, device="cpu")
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)
    stats = calibrate(cfg, params, [tokens[:2], tokens[2:]])
    assert sorted(os.listdir(d)) == sorted(
        n.replace(".", "_") for n in layer_names(cfg))
    for name in layer_names(cfg):
        path = d / name.replace(".", "_")
        assert sorted(os.listdir(path)) == ["bias.npy", "hessian.npy",
                                            "mean.npy", "weight.npy"]
        p = get_linear_param(params, name)
        want = {"weight": p["kernel"].T, "hessian": stats[name].hessian,
                "mean": stats[name].mean, "bias": p["bias"]}
        for key, x in want.items():
            got = np.load(path / f"{key}.npy")
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, x.numpy(), err_msg=str(path))


def test_dumps_load_in_both_packages(jax_dump, tmp_path):
    """Each package's dump loads in the other's ``load_layer`` (dead
    columns repaired) to the values its own gives."""
    port = tmp_path / "port"
    run_main(dump_stats.main, [str(port)] + DUMP + ["--device", "cpu"])
    assert len(common.find_layer_dirs(str(port))) == 12
    for root in (str(port), jax_dump):
        assert (common.find_layer_dirs(root)
                == jcommon.find_layer_dirs(root))
        for layer in common.find_layer_dirs(root):
            got = common.load_layer(layer, torch.device("cpu"))
            want = jcommon.load_layer(layer)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
