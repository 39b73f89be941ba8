"""PyTorch/CUDA port of sleekit-tpu (the quantizer and the serving path),
for NVIDIA Hopper.

The JAX package ``sleekit_tpu`` stays the reference; this package mirrors
its module names (``sleekit_tpu_torch/ops/pack.py`` <->
``sleekit_tpu/ops/pack.py`` and so on) and never imports ``jax`` or
anything of ``sleekit_tpu``.

Every entry point (``Engine``, ``random_packed_params``,
``params_from_numpy``, ``init_kv_cache``, ``init_params``,
``load_hf_checkpoint``, the quantizer's constructors, and the commands
``experiments/quantize_model_cli.py`` and ``serve_cli.py`` with their
``--device cpu``) runs on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device and without that argument they
raise ``RuntimeError``. ``Sleekit`` runs on its layer's device.

The serving kernels (the Pallas kernels of the JAX package) are CUDA C++
for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(:mod:`sleekit_tpu_torch.kernels`). Each has a plain PyTorch version in
the same module; a wrapper takes the plain version only for a tensor that
lies on the CPU. Importing the package builds nothing: a kernel is built
at its first launch.

The package exports the quantizer's public API, as ``sleekit_tpu`` does:
``Sleekit`` (the reference's torch-facing class, :mod:`.compat`),
``LayerQuantizer``, ``QuantConfig``, ``UniformCodebook``, ``Codebook``,
``lloyd_max`` and the quantizer's submodules.
"""

from sleekit_tpu_torch import (  # noqa: E402
    codebooks, hessian, local_search, pipeline, scaling, solver)
from sleekit_tpu_torch.codebooks import (  # noqa: E402
    Codebook, UniformCodebook, lloyd_max)
from sleekit_tpu_torch.compat import Sleekit  # noqa: E402
from sleekit_tpu_torch.pipeline import (  # noqa: E402
    LayerQuantizer, QuantConfig)

__all__ = [
    "codebooks",
    "hessian",
    "solver",
    "scaling",
    "local_search",
    "pipeline",
    "UniformCodebook",
    "Codebook",
    "lloyd_max",
    "LayerQuantizer",
    "QuantConfig",
    "Sleekit",
]
