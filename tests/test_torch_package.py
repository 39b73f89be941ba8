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


def test_port_imports_no_jax_and_no_sleekit_tpu():
    """Every module of the port imports in a fresh interpreter without
    pulling jax or sleekit_tpu into sys.modules (a subprocess: conftest
    imports jax into this one)."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        sleekit_tpu_torch.__path__, "sleekit_tpu_torch."))
    assert {"sleekit_tpu_torch.serve.engine",
            "sleekit_tpu_torch.serve.checkpoint",
            "sleekit_tpu_torch.codebooks"} <= set(names)
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
    Engine(cfg, params, device="cpu")
    Engine(cfg, params, device="cpu", paged=True)


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(paged=True, page_size=4), ValueError, "page_size 4"),
    (dict(paged=True, page_size=48), ValueError, "multiple of page_size 48"),
    (dict(mesh=object()), NotImplementedError, "item 15")])
def test_unported_engine_modes_name_their_roadmap_item(kwargs, error, match):
    """Mesh serving is not ported and names its ROADMAP item; a page size
    the JAX kernels refuse (not a multiple of their 8-row append window,
    or not dividing max_seq_len 512) is refused at construction."""
    from sleekit_tpu_torch.models.fake_quant import random_packed_params
    from sleekit_tpu_torch.models.zoo import tiny_test
    from sleekit_tpu_torch.serve.engine import Engine

    cfg = tiny_test()
    params, _ = random_packed_params(cfg, 0, device="cpu")
    with pytest.raises(error, match=match):
        Engine(cfg, params, device="cpu", **kwargs)


def test_kernel_sources_and_build_paths():
    """Every kernel names a CUDA source in the package and the TPU kernel
    it replaces; the build output goes to the git-ignored _build dir, and
    a source's library name changes with its text."""
    from sleekit_tpu_torch import kernels
    from sleekit_tpu_torch.ops import (  # noqa: F401
        attention, dequant_matmul, paged_attention)

    names = {k.name: k for k in kernels.KERNELS}
    assert set(names) == {"K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8",
                          "K9", "K10", "K11", "K14", "K15"}
    assert {k.source for k in names.values()} == {
        p.name for p in kernels.CSRC.glob("*.cu")}
    for k in names.values():
        assert (kernels.CSRC / k.source).exists()
        assert k.replaces.startswith("sleekit_tpu/ops/")
        path = kernels.library_path(k.source)
        assert path.parent == kernels.BUILD_DIR and path.suffix == ".so"
    assert "sleekit_tpu_torch/_build/" in (ROOT / ".gitignore").read_text()
    assert "--use_fast_math" not in kernels.NVCC_FLAGS
