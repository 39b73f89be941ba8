"""Drop-in torch-facing API: the reference's ``Sleekit`` class (port of
``sleekit_tpu/compat.py``).

Wrap one ``nn.Linear``, ``nn.Conv1d`` or ``nn.Conv2d`` (or an HF
``Conv1D``, the GPT-2-style linear whose weight is stored (in, out)),
stream activation batches into it from a forward hook that the caller
registers, then quantize the layer in place. The API is the reference's,
which GPTQ harnesses depend on: ``Sleekit(layer)``, ``add_batch(inp,
out=None)``, ``export(path, npy_format=False)``, ``quantize(nbits, ...)``
with the reference keyword signature, the three presets, ``free()``, and
the ``count`` / ``mean`` / ``hessian`` / ``device`` attributes.

The statistics and the solve run on the layer's own device through
:class:`~sleekit_tpu_torch.pipeline.LayerQuantizer`; ``quantize`` writes
the dequantized weights into ``layer.weight`` (and, with bias correction,
``layer.bias``) in place. A layer on the CPU is its owner asking for the
CPU.
"""

from __future__ import annotations

import torch

from sleekit_tpu_torch.pipeline import (
    LayerQuantizer, QuantConfig, preset_config)

__all__ = ["Sleekit"]


def _is_hf_conv1d(layer) -> bool:
    """Duck-typed transformers.Conv1D: 2-D weight stored (in, out) with an
    ``nf`` output-features attribute; avoids a hard transformers import."""
    return (type(layer).__name__ == "Conv1D" and hasattr(layer, "nf")
            and getattr(layer, "weight", None) is not None
            and layer.weight.ndim == 2)


class Sleekit:
    """Statistics of a layer, with an API compatible with GPTQ harnesses.
    Computation runs on the layer's device."""

    def __init__(self, layer):
        import torch.nn as nn

        self.layer = layer
        self._hf_conv1d = _is_hf_conv1d(layer)
        if self._hf_conv1d:
            kind, kwargs = "linear", {}
            weight = layer.weight.t()  # HF Conv1D stores (in, out)
        elif isinstance(layer, nn.Linear):
            kind, kwargs = "linear", {}
            weight = layer.weight
        elif isinstance(layer, nn.Conv1d):
            kind = "conv1d"
            kwargs = dict(kernel_size=layer.kernel_size[0],
                          dilation=layer.dilation[0],
                          padding=layer.padding[0],
                          stride=layer.stride[0])
            weight = layer.weight
        elif isinstance(layer, nn.Conv2d):
            kind = "conv2d"
            kwargs = dict(kernel_size=tuple(layer.kernel_size),
                          dilation=tuple(layer.dilation),
                          padding=tuple(layer.padding),
                          stride=tuple(layer.stride))
            weight = layer.weight
        else:
            raise ValueError(f"Unsupported layer type {type(layer)}")
        bias = getattr(layer, "bias", None)
        def f32(t):
            return t.detach().to(torch.float32, copy=True)

        self._lq = LayerQuantizer(
            f32(weight), bias=None if bias is None else f32(bias), kind=kind,
            device=weight.device, **kwargs)

    # ---- reference attribute surface ----------------------------------

    @property
    def device(self):
        return self.layer.weight.device

    @property
    def count(self) -> int:
        return 0 if self._lq.stats is None else self._lq.count

    @property
    def mean(self) -> torch.Tensor:
        return self._lq.stats.mean

    @property
    def hessian(self) -> torch.Tensor:
        return self._lq.stats.hessian

    # ---- statistics ----------------------------------------------------

    def add_batch(self, inp, out=None) -> None:
        """Fold one activation batch into the running statistics. ``out``
        is accepted for hook-signature compatibility and ignored, like the
        reference."""
        self._lq.add_batch(inp.detach())

    def export(self, path: str, npy_format: bool = False) -> None:
        """Dump bias/weight/mean/hessian artifacts (the reference default
        is torch ``.pt``)."""
        self._lq.export(path, npy_format=npy_format)

    # ---- quantization ----------------------------------------------------

    def quantize(self, nbits, scaling_mode="mse", order_mode="diag",
                 bias_correction=False, damp=0.01, nb_ls_moves=0,
                 grid_size=100, min_factor=0.05, max_factor=1.0) -> None:
        """Quantize the layer in place to the required precision, with the
        reference keyword signature and semantics: symmetric uniform
        2**nbits codebook, the dequantized weights written into
        ``layer.weight``, the bias updated by ``(W - Q)·mean`` when
        correcting."""
        cfg = QuantConfig(
            nbits=nbits, scaling_mode=scaling_mode, order_mode=order_mode,
            bias_correction=bias_correction, damp=damp,
            nb_ls_moves=nb_ls_moves, grid_size=grid_size,
            min_factor=min_factor, max_factor=max_factor)
        Q, _, _ = self._lq.quantize(cfg)
        if self._hf_conv1d:
            Q = Q.T
        with torch.no_grad():
            self.layer.weight.copy_(Q.reshape(self.layer.weight.shape))
            if bias_correction and self.layer.bias is not None:
                self.layer.bias.copy_(self._lq.bias)

    def _preset(self, name: str, nbits) -> None:
        p = preset_config(name, nbits)
        self.quantize(nbits, scaling_mode=p.scaling_mode,
                      order_mode=p.order_mode,
                      bias_correction=p.bias_correction, damp=p.damp,
                      nb_ls_moves=p.nb_ls_moves)

    def quantize_basic(self, nbits) -> None:
        """Standard GPTQ, no sleekit improvements."""
        self._preset("basic", nbits)

    def quantize_sleekit_light(self, nbits) -> None:
        """Sleekit "light": no extra computational cost."""
        self._preset("light", nbits)

    def quantize_sleekit_heavy(self, nbits) -> None:
        """Sleekit "heavy": scaling grid over full GPTQ sweeps + local
        search."""
        self._preset("heavy", nbits)

    def free(self) -> None:
        """Release internal tensors."""
        self.layer = None
        self._lq.free()
