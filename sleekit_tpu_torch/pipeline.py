"""Layer quantization pipeline: statistics -> scaling -> solve -> bias fix
(port of ``sleekit_tpu/pipeline.py``).

``quantize_layer`` runs the per-layer pipeline (optional bias correction
of the Hessian, scaling search, GPTQ solve, local search, the bias
update) on the device of its tensors; ``LayerQuantizer`` accumulates one
layer's statistics from activation batches. The presets are the
reference's ``basic`` / ``sleekit light`` / ``sleekit heavy``.

Artifacts keep the reference's per-layer ``data/<layer>/{weight,hessian,
mean,bias}.npy`` layout (or ``.pt``), so a directory exported by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from sleekit_tpu_torch.codebooks import Codebook, UniformCodebook, lloyd_max
from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.hessian import (
    init_stats, prepare_input_conv1d, prepare_input_conv2d,
    prepare_input_linear, remove_input_bias, stats_from_numpy, update_stats)
from sleekit_tpu_torch.scaling import (
    compute_norm_scaling, compute_scaling, quantize_with_scaling)
from sleekit_tpu_torch.solver import channelwise_error


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Every knob of the per-layer pipeline."""

    nbits: float = 3
    codebook_size: Optional[int] = None  # overrides 2**nbits when set
    # 'uniform' (symmetric over [-1, 1]), 'nf4', or 'lloyd' (Lloyd-Max
    # trained per layer on its norm-scaled weights).
    codebook_kind: str = "uniform"
    scaling_mode: str = "mse"
    order_mode: str = "diag"
    bias_correction: bool = False
    damp: float = 0.01
    nb_ls_moves: int = 0
    grid_size: int = 100
    min_factor: float = 0.05
    max_factor: float = 1.0
    block_size: int = 128
    # > 0: coarse-then-fine 'obq' scaling search (2 * obq_refine sweeps).
    obq_refine: int = 0

    def resolved_codebook_size(self) -> int:
        if self.codebook_size is not None:
            return self.codebook_size
        return int(round(2 ** self.nbits))

    def make_codebook(self, weight: Optional[torch.Tensor] = None):
        """The codebook of ``codebook_kind``; 'lloyd' trains on ``weight``
        (out, in), on its device."""
        if self.codebook_kind == "uniform":
            return UniformCodebook(self.resolved_codebook_size(), -1.0, 1.0)
        if self.codebook_kind == "nf4":
            return Codebook.nf4()
        if self.codebook_kind == "lloyd":
            if weight is None:
                raise ValueError("a 'lloyd' codebook trains on the weights")
            w = weight.float()
            sc = compute_norm_scaling(w, 0)
            return lloyd_max(w / sc[:, None], self.resolved_codebook_size(),
                             sample_count=4096)
        raise ValueError(f"unknown codebook_kind {self.codebook_kind}")


# The reference presets. Heavy uses 100 local-search moves: the code's
# value, not its README's "1000".
PRESETS = {
    "basic": dict(scaling_mode="mse", order_mode="diag",
                  bias_correction=False, damp=0.01, nb_ls_moves=0),
    "light": dict(scaling_mode="diag", order_mode="sqerr",
                  bias_correction=True, damp=0.03, nb_ls_moves=0),
    "heavy": dict(scaling_mode="hessian", order_mode="sqerr",
                  bias_correction=True, damp=0.03, nb_ls_moves=100),
}


def preset_config(name: str, nbits: float = 3, **overrides) -> QuantConfig:
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return QuantConfig(nbits=nbits, **kw)


def quantize_layer(weight: torch.Tensor, hessian: torch.Tensor,
                   mean: torch.Tensor, config: QuantConfig, codebook=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """The per-layer pipeline on the tensors' device. Returns (Q, the
    dequantized f32 weights; the bias delta (W - Q) @ mean; the
    per-channel scale; the per-channel error against the Hessian it
    optimized). ``codebook`` overrides the config's (a trained one).

    ``weight`` (m, n), ``hessian`` (n, n), ``mean`` (n,); or a stack of
    independent layers of one shape, (L, m, n), (L, n, n) and (L, n), one
    codebook for all, solved at once (every output with L leading)."""
    if (weight.ndim not in (2, 3)
            or hessian.shape != (*weight.shape[:-2], weight.shape[-1],
                                 weight.shape[-1])
            or mean.shape != hessian.shape[:-1]):
        raise ValueError(
            f"quantize_layer takes weight ([L,] m, n), hessian ([L,] n, n) "
            f"and mean ([L,] n), not {tuple(weight.shape)}, "
            f"{tuple(hessian.shape)} and {tuple(mean.shape)}")
    cb = codebook if codebook is not None else config.make_codebook()
    W = weight.float()
    H = hessian.float()
    mean = mean.float()
    if config.bias_correction:
        H = remove_input_bias(H, mean)
    scale = compute_scaling(
        W, cb, H, mode=config.scaling_mode, axis=None,
        grid_size=config.grid_size, min_factor=config.min_factor,
        max_factor=config.max_factor, block_size=config.block_size,
        obq_refine=config.obq_refine)
    Q = quantize_with_scaling(
        W, scale, cb, H=H, act_order=config.order_mode, damp=config.damp,
        nb_ls_moves=config.nb_ls_moves, block_size=config.block_size)
    bias_delta = torch.sum((W - Q) * mean[..., None, :], dim=-1)
    return Q, bias_delta, scale, channelwise_error(W, Q, H)


def _load_array(path: str, name: str) -> Optional[np.ndarray]:
    """``<path>/<name>.npy``, else ``.pt``, as an array; None if
    neither exists."""
    npy = os.path.join(path, f"{name}.npy")
    if os.path.exists(npy):
        return np.load(npy)
    pt = os.path.join(path, f"{name}.pt")
    if os.path.exists(pt):
        return torch.load(pt, map_location="cpu", weights_only=True).numpy()
    return None


class LayerQuantizer:
    """Statistics and quantization of one layer: ``kind`` 'linear',
    'conv1d' or 'conv2d' (conv weights flattened to (out, in*k...)). Its
    tensors live on ``device``, the CUDA device unless the caller passes
    another."""

    def __init__(self, weight, bias=None, kind: str = "linear",
                 kernel_size=None, dilation=None, padding=None, stride=None,
                 device="cuda"):
        if kind not in ("linear", "conv1d", "conv2d"):
            raise ValueError(f"Unsupported layer kind {kind}")
        self.device = resolve_device(device)
        weight = torch.as_tensor(weight).to(self.device, torch.float32)
        self.kind = kind
        self.weight_shape = tuple(weight.shape)
        self.weight = weight.reshape(weight.shape[0], -1)
        self.bias = (None if bias is None else
                     torch.as_tensor(bias).to(self.device, torch.float32))
        self.kernel_size = kernel_size
        self.dilation = dilation
        self.padding = padding
        self.stride = stride
        self.stats = init_stats(self.weight.shape[1], self.device)

    @property
    def count(self) -> int:
        return int(self.stats.count)

    def _prepare_input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device)
        if self.kind == "linear":
            return prepare_input_linear(x)
        if self.kind == "conv2d":
            return prepare_input_conv2d(
                x, self.kernel_size, self.dilation or (1, 1),
                self.padding or (0, 0), self.stride or (1, 1))
        return prepare_input_conv1d(
            x, self.kernel_size, self.dilation or 1, self.padding or 0,
            self.stride or 1)

    def add_batch(self, x) -> None:
        """Fold one activation batch into the running statistics."""
        self.stats = update_stats(self.stats, self._prepare_input(x))

    # ---- artifact I/O (the reference's layout) ------------------------

    def export(self, path: str, npy_format: bool = True) -> None:
        """Write weight/hessian/mean/bias to ``path`` as ``.npy`` files (the
        reference's layout), or as ``.pt`` with ``npy_format=False``."""
        os.makedirs(path, exist_ok=True)
        tensors = {"weight": self.weight.reshape(self.weight_shape),
                   "hessian": self.stats.hessian, "mean": self.stats.mean}
        if self.bias is not None:
            tensors["bias"] = self.bias
        for name, x in tensors.items():
            x = x.detach().cpu().contiguous()
            if npy_format:
                np.save(os.path.join(path, f"{name}.npy"), x.numpy())
            else:
                torch.save(x, os.path.join(path, f"{name}.pt"))

    @classmethod
    def load(cls, path: str, device="cuda") -> "LayerQuantizer":
        """A quantizer from an artifact directory (``.npy`` or ``.pt``), its
        statistics counted as one sample."""
        arrays = {name: _load_array(path, name)
                  for name in ("weight", "hessian", "mean", "bias")}
        lq = cls(arrays["weight"], bias=arrays["bias"], device=device)
        lq.stats = stats_from_numpy(arrays["mean"], arrays["hessian"], 1.0,
                                    lq.device)
        return lq

    # ---- quantization -------------------------------------------------

    def quantize(self, config: QuantConfig):
        """Run the pipeline: ``weight`` becomes the dequantized f32 Q and,
        with bias correction, ``bias`` takes the delta. Returns (Q in the
        weight's shape, scale, per-channel error)."""
        codebook = None
        if config.codebook_kind != "uniform":
            codebook = config.make_codebook(self.weight)
        Q, bias_delta, scale, err = quantize_layer(
            self.weight, self.stats.hessian, self.stats.mean, config,
            codebook)
        self.weight = Q
        if config.bias_correction and self.bias is not None:
            self.bias = self.bias + bias_delta
        return Q.reshape(self.weight_shape), scale, err

    def quantize_basic(self, nbits: float = 3, **overrides):
        return self.quantize(preset_config("basic", nbits, **overrides))

    def quantize_sleekit_light(self, nbits: float = 3, **overrides):
        return self.quantize(preset_config("light", nbits, **overrides))

    def quantize_sleekit_heavy(self, nbits: float = 3, **overrides):
        return self.quantize(preset_config("heavy", nbits, **overrides))

    def free(self) -> None:
        self.weight = None
        self.bias = None
        self.stats = None
