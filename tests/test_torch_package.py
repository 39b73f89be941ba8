"""Hygiene of the port: it imports neither jax nor anything of sleekit_tpu,
and its entry points never fall back to the CPU on their own."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sleekit_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

# The reference's ablation CLIs, ported under the same module names.
ABLATION_CLIS = ("common", "dump_stats", "compare", "bits", "scaling",
                 "correction", "ordering", "dampening", "local_search",
                 "distribution", "results")


def test_port_imports_no_jax_and_no_sleekit_tpu():
    """Every module of the port imports in a fresh interpreter without
    pulling jax or sleekit_tpu into sys.modules (a subprocess: conftest
    imports jax into this one)."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        sleekit_tpu_torch.__path__, "sleekit_tpu_torch."))
    assert {"sleekit_tpu_torch.serve.engine",
            "sleekit_tpu_torch.serve.checkpoint",
            "sleekit_tpu_torch.codebooks"} <= set(names)
    assert {f"sleekit_tpu_torch.experiments.{m}" for m in ABLATION_CLIS} <= (
        set(names))
    assert {f"sleekit_tpu_torch.parallel.{m}" for m in (
        "mesh", "distributed", "tp_decode", "comm_model")} <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'sleekit_tpu' "
        "or m.startswith('sleekit_tpu.'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_entry_points_raise_without_cuda(tmp_path):
    """Without a CUDA device, the entry points raise unless the caller
    passes device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run there")
    from sleekit_tpu_torch.convert import params_from_numpy
    from sleekit_tpu_torch.experiments import (
        attn_bench, kernel_bench, prefill_bench, profile_decode)
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.transformer import (
        init_kv_cache, init_paged_kv_cache)
    from sleekit_tpu_torch.models.zoo import tiny_test
    from sleekit_tpu_torch.serve.checkpoint import (
        load_packed_params, save_packed_params)
    from sleekit_tpu_torch.serve.engine import Engine

    cfg = tiny_test()
    params, _ = random_packed_params(cfg, 0, device="cpu")
    save_packed_params(str(tmp_path), params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_packed_params(str(tmp_path))
    load_packed_params(str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        random_packed_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_paged_kv_cache(cfg, 3, 8, 1, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, paged=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(cfg, {"layers": []})
    for bench, argv in ((attn_bench, ["--model", "tiny"]),
                        (profile_decode, ["--model", "tiny"]),
                        (kernel_bench, ["--shapes", "64x64"]),
                        (prefill_bench, ["--model", "tiny"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main(argv)
    Engine(cfg, params, device="cpu")
    Engine(cfg, params, device="cpu", paged=True)

    # Tensor parallelism: the group and the mesh.
    from sleekit_tpu_torch.parallel.distributed import init_process_group
    from sleekit_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_process_group(rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()
    assert make_mesh(device="cpu").device == torch.device("cpu")

    # The quantizer's constructors.
    import numpy as np
    from sleekit_tpu_torch.hessian import (
        init_stats, random_psd_matrix, stats_from_numpy)
    from sleekit_tpu_torch.models.transformer import init_calibration_stats
    from sleekit_tpu_torch.pipeline import LayerQuantizer

    w = np.ones((4, 8), np.float32)
    LayerQuantizer(w, device="cpu").export(str(tmp_path / "layer"))
    for make in (lambda: LayerQuantizer(w),
                 lambda: LayerQuantizer.load(str(tmp_path / "layer")),
                 lambda: stats_from_numpy(np.zeros(8), np.eye(8)),
                 lambda: init_stats(8), lambda: random_psd_matrix(0, 8, 2),
                 lambda: init_calibration_stats(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    LayerQuantizer.load(str(tmp_path / "layer"), device="cpu")

    # The user's two commands and the HF reader.
    from sleekit_tpu_torch.experiments import quantize_model_cli, serve_cli
    from sleekit_tpu_torch.models.hf import load_hf_checkpoint

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_hf_checkpoint(cfg, "opt-tiny", str(tmp_path / "no-such-dir"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_model_cli.main([str(tmp_path / "q"), "--model", "tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main([str(tmp_path), "--model", "tiny"])
    assert not (tmp_path / "q").exists()

    # The ablation CLIs: every one but ``results`` (numpy only, no
    # device) runs on the card unless told otherwise.
    import importlib

    for name in ABLATION_CLIS:
        if name in ("common", "results"):
            continue
        cli = importlib.import_module(f"sleekit_tpu_torch.experiments.{name}")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([str(tmp_path / "d")])
    assert not (tmp_path / "d").exists()


def test_sleekit_follows_its_layer():
    """``Sleekit`` has no device argument: its statistics and solve live on
    the wrapped layer's device, so a layer on the CPU is its owner asking
    for the CPU, and a CUDA layer keeps everything on the card."""
    import torch.nn as nn

    from sleekit_tpu_torch import Sleekit

    stats = Sleekit(nn.Linear(8, 4))
    stats.add_batch(torch.randn(3, 8))
    assert stats.device == stats.hessian.device == stats.mean.device == (
        torch.device("cpu"))


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(paged=True, page_size=4), ValueError, "page_size 4"),
    (dict(paged=True, page_size=48), ValueError, "multiple of page_size 48"),
    (dict(mesh=(2, 1)), ValueError, "data=2 x model=1 needs a group of 2")])
def test_unported_engine_modes_name_their_roadmap_item(kwargs, error, match):
    """A mesh with a data axis needs a process group of its ranks:
    ``make_mesh(data=2)`` without one is refused (replicas are served by
    ``serve/router.py``, one Engine a replica); a page size the JAX
    kernels refuse (not a multiple of their 8-row append window, or not
    dividing max_seq_len 512) is refused at construction."""
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.zoo import tiny_test
    from sleekit_tpu_torch.parallel.mesh import make_mesh
    from sleekit_tpu_torch.serve.engine import Engine

    cfg = tiny_test()
    params, _ = random_packed_params(cfg, 0, device="cpu")
    with pytest.raises(error, match=match):
        if "mesh" in kwargs:
            data, model = kwargs["mesh"]
            kwargs = dict(mesh=make_mesh(data=data, model=model,
                                         device="cpu"))
        Engine(cfg, params, device="cpu", **kwargs)


def test_kernel_sources_and_build_paths():
    """Every TPU kernel, K1 to K15 and the f32 route of K8 and K9 (K8f,
    K9f), has a CUDA kernel that names its source in the package and the
    TPU kernel it replaces; the build output goes to the git-ignored
    _build dir, and a source's library name changes with its text."""
    from sleekit_tpu_torch import kernels
    from sleekit_tpu_torch.ops import (  # noqa: F401
        attention, dequant_matmul, paged_attention)

    names = {k.name: k for k in kernels.KERNELS}
    assert set(names) == {f"K{i}" for i in range(1, 16)} | {"K8f", "K9f"}
    assert {k.source for k in names.values()} == {
        p.name for p in kernels.CSRC.glob("*.cu")}
    for k in names.values():
        assert (kernels.CSRC / k.source).exists()
        assert k.replaces.startswith("sleekit_tpu/ops/")
        path = kernels.library_path(k.source)
        assert path.parent == kernels.BUILD_DIR and path.suffix == ".so"
    assert "sleekit_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
