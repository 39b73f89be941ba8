"""PyTorch/CUDA port of sleekit-tpu's serving path, for NVIDIA Hopper.

The JAX package ``sleekit_tpu`` stays the reference; this package mirrors
its module names (``sleekit_tpu_torch/ops/pack.py`` <->
``sleekit_tpu/ops/pack.py`` and so on) and never imports ``jax`` or
anything of ``sleekit_tpu``.

Every entry point (``Engine``, ``random_packed_params``,
``params_from_numpy``, ``init_kv_cache``, ``init_params``) runs on the
CUDA device unless the caller passes ``device="cpu"``; without a CUDA
device and without that argument they raise ``RuntimeError``.

The serving kernels (the Pallas kernels of the JAX package) are CUDA C++
for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(:mod:`sleekit_tpu_torch.kernels`). Each has a plain PyTorch version in
the same module; a wrapper takes the plain version only for a tensor that
lies on the CPU.
"""
