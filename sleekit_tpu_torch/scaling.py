"""Per-channel scaling-factor search (port of ``sleekit_tpu/scaling.py``).

Closed forms (norm, non-saturating max) and grid searches over factors of
the non-saturating scale: round-to-nearest error (``mse``, ``diag[P]``,
``hessian[P]``) or a full GPTQ sweep a factor (``obq``). The factor grid
is built as ``jnp.linspace`` computes it in the JAX package's compiled
search, in f32, so the port's factors are the JAX package's bit for bit
(``torch.linspace`` differs in the last bit of some).

Each function takes ``data`` with its channels on ``axis``, or, with
``axis=None``, a matrix (m, n) or a stack of independent layers (L, m, n)
scaled per row, with H (L, n, n) a layer: the batched layer solve runs
every grid factor once for all L layers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sleekit_tpu_torch.hessian import dampen, diag_of, hessian_inv_chol
from sleekit_tpu_torch.solver import (
    compute_order, gptq_sweep, permute_columns, permute_hessian,
    quantize_opt)


def grid_factors(start: float, stop: float, num: int) -> np.ndarray:
    """The grid of ``jnp.linspace(start, stop, num, dtype=float32)`` as the
    JAX package's compiled search computes it (constant bounds under
    jit), in numpy f32: with r = f32(1 / (num - 1)) (XLA multiplies by
    the reciprocal of a constant divisor) and i = 0 .. num - 2,
    start * (1 - i * r) + i * f32(stop * r) (XLA folds stop * r), then
    ``stop`` itself."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.asarray([start])
    r = np.float32(1) / np.float32(num - 1)
    i = np.arange(num - 1, dtype=np.float32)
    out = start * (np.float32(1) - i * r) + i * (stop * r)
    return np.append(out, stop).astype(np.float32)


# ---- application -----------------------------------------------------------


def apply_scaling(data: torch.Tensor, scale: torch.Tensor,
                  axis: int = 0) -> torch.Tensor:
    """Divide out a per-channel scale along ``axis``."""
    shape = [1] * data.ndim
    shape[axis] = -1
    return data / scale.reshape(shape)


# ---- closed-form scalings --------------------------------------------------


def _reduced_axes(data: torch.Tensor, axis: Optional[int]):
    """The axes a per-channel statistic reduces: all but ``axis``, or the
    last (``axis=None``: the rows of each matrix are the channels)."""
    if axis is None:
        return (-1,)
    return tuple(i for i in range(data.ndim) if i != axis)


def compute_norm_scaling(data: torch.Tensor,
                         axis: Optional[int] = 0) -> torch.Tensor:
    """Scale for unit RMS per channel."""
    sqnorm = torch.mean(torch.square(data), dim=_reduced_axes(data, axis))
    return torch.sqrt(torch.clamp(sqnorm, min=1e-16))


def compute_non_saturating_scaling(data: torch.Tensor, codebook,
                                   axis: Optional[int] = 0) -> torch.Tensor:
    """Smallest per-channel scale with no saturation against the codebook
    range. Requires a mixed-sign codebook."""
    mincode, maxcode = codebook.min(), codebook.max()
    if float(mincode) >= 0 or float(maxcode) <= 0:
        raise ValueError(
            "Codebook should have both negative and positive values.")
    other = _reduced_axes(data, axis)
    mindata = torch.amin(data, dim=other)
    maxdata = torch.amax(data, dim=other)
    # Divide by tensors: CUDA divides by a Python number as a product
    # with its reciprocal.
    scale = torch.maximum(maxdata / maxdata.new_tensor(float(maxcode)),
                          mindata / mindata.new_tensor(float(mincode)))
    return torch.clamp(scale, min=1e-16)


# ---- scale-then-optimize ---------------------------------------------------


def quantize_with_scaling(data: torch.Tensor, scale: torch.Tensor, quantizer,
                          H: Optional[torch.Tensor] = None,
                          act_order: str = "diag", damp: float = 0.01,
                          nb_ls_moves: int = 0,
                          block_size: int = 128) -> torch.Tensor:
    """Divide by the scale, solve (GPTQ if H is given, else round), multiply
    back. ``data`` ([L,] m, n), ``scale`` ([L,] m)."""
    if data.ndim not in (2, 3) or scale.shape != data.shape[:-1]:
        raise ValueError("quantize_with_scaling takes data ([L,] m, n) and "
                         "a scale ([L,] m)")
    scaled = data / scale[..., None]
    if H is not None:
        q = quantize_opt(scaled, H, quantizer, act_order=act_order,
                         damp=damp, nb_ls_moves=nb_ls_moves,
                         block_size=block_size)
    else:
        q = quantizer(scaled)
    return q * scale[..., None]


# ---- grid searches ---------------------------------------------------------


def _weighted_mse(H: Optional[torch.Tensor], E: torch.Tensor) -> torch.Tensor:
    """Per-channel error: plain MSE (H None), diagonal-weighted (H a
    diagonal a layer) or the full quadratic form (H a matrix a layer)."""
    if H is None:
        return torch.sum(torch.square(E), dim=-1)
    if H.ndim == E.ndim - 1:
        return torch.sum(H[..., None, :] * torch.square(E), dim=-1)
    return torch.sum((E @ H) * E, dim=-1)


def _rows(data: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """The data as f32 matrices with one channel a row: ``data`` itself
    for ``axis=None``, else the channel axis moved first and the rest
    flattened."""
    if axis is None:
        return data.float()
    other = tuple(i for i in range(data.ndim) if i != axis)
    return data.permute(axis, *other).reshape(data.shape[axis], -1).float()


def _grid_argmin(factors, eval_factor, channels, device,
                 return_err: bool = False):
    """Per-channel best factor over ``factors`` (f32 scalars, or tensors
    of per-channel factors of shape ``channels``); the first wins on ties
    (a strict < update)."""
    best_err = torch.full(channels, torch.inf, device=device)
    best_choice = torch.full(channels, torch.inf, device=device)
    for s in factors:
        err = eval_factor(s)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_choice = torch.where(better, s, best_choice)
    if return_err:
        return best_choice, best_err
    return best_choice


def compute_min_mse_scaling(data: torch.Tensor, codebook,
                            axis: Optional[int] = 0,
                            H: Optional[torch.Tensor] = None,
                            min_factor: float = 0.05, max_factor: float = 1.0,
                            grid_size: int = 100) -> torch.Tensor:
    """Grid search over [min_factor, max_factor] x the non-saturating scale,
    scoring each channel's round-to-nearest error."""
    flat = _rows(data, axis)
    initial_scale = compute_non_saturating_scaling(flat, codebook, None)

    def eval_factor(s):
        scale = (s * initial_scale)[..., None]
        return _weighted_mse(H, codebook(flat / scale) * scale - flat)

    factors = grid_factors(min_factor, max_factor, grid_size).tolist()
    return initial_scale * _grid_argmin(factors, eval_factor,
                                        flat.shape[:-1], flat.device)


def compute_obq_scaling(data: torch.Tensor, codebook, axis: Optional[int],
                        H: torch.Tensor, damp: float = 0.01,
                        act_order: str = "diag", min_factor: float = 0.05,
                        max_factor: float = 1.0, grid_size: int = 100,
                        block_size: int = 128,
                        refine: int = 0) -> torch.Tensor:
    """Score every grid factor by a full GPTQ sweep; the ordering and the
    inverse-Hessian factor are computed once.

    ``refine > 0``: a coarse grid of ``refine`` factors over the range,
    then ``refine`` per-channel factors over +-1 coarse step around each
    channel's winner (2 * refine sweeps), keeping the coarse winner where
    it scores lower."""
    W = _rows(data, axis)
    initial_scale = compute_non_saturating_scaling(W, codebook, None)
    H = H.float()
    H_opt = dampen(H, damp)
    order = compute_order(W / initial_scale[..., None], H_opt, codebook,
                          act_order)
    Wp = permute_columns(W, order)
    Hperm = permute_hessian(H, order)
    Hinv = hessian_inv_chol(permute_hessian(H_opt, order))

    def eval_factor(s):
        scale = (s * initial_scale)[..., None]
        Q = gptq_sweep(Wp / scale, Hinv, codebook,
                       block_size=block_size) * scale
        return _weighted_mse(Hperm, Q - Wp)

    channels, dev = W.shape[:-1], W.device
    if refine > 0:
        coarse = grid_factors(min_factor, max_factor, refine).tolist()
        center, e_center = _grid_argmin(coarse, eval_factor, channels, dev,
                                        return_err=True)
        step = (max_factor - min_factor) / max(refine - 1, 1)
        offsets = torch.from_numpy(grid_factors(-step, step, refine)).to(dev)
        fine = torch.clamp(
            center[None] + offsets.reshape(-1, *[1] * center.ndim),
            min_factor, max_factor)
        best, e_best = _grid_argmin(fine, eval_factor, channels, dev,
                                    return_err=True)
        return initial_scale * torch.where(e_center < e_best, center, best)
    factors = grid_factors(min_factor, max_factor, grid_size).tolist()
    return initial_scale * _grid_argmin(factors, eval_factor, channels, dev)


# ---- dispatcher ------------------------------------------------------------


def compute_scaling(data: torch.Tensor, codebook, H: Optional[torch.Tensor],
                    mode: str = "mse", axis: Optional[int] = 0,
                    min_factor: float = 0.05, max_factor: float = 1.0,
                    grid_size: int = 100, obq_damp: float = 0.01,
                    obq_act_order: str = "diag", block_size: int = 128,
                    obq_refine: int = 0) -> torch.Tensor:
    """Mode dispatch: ``max``, ``norm``, ``obq``, ``mse``, and ``diag[P]`` /
    ``hessian[P]``, whose suffix adds P% more dampening before the grid
    search."""
    if mode == "max":
        return compute_non_saturating_scaling(data, codebook, axis)
    if mode == "norm":
        return compute_norm_scaling(data, axis)
    if mode == "obq":
        return compute_obq_scaling(
            data, codebook, axis, H=H, damp=obq_damp,
            act_order=obq_act_order, grid_size=grid_size,
            min_factor=min_factor, max_factor=max_factor,
            block_size=block_size, refine=obq_refine)
    if mode == "mse":
        H = None
    elif mode.startswith("hessian"):
        if len(mode) > 7:
            H = dampen(H, 0.01 * float(mode[7:]))
    elif mode.startswith("diag"):
        H = diag_of(H)
        if len(mode) > 4:
            H = H + 0.01 * float(mode[4:]) * torch.mean(H, dim=-1,
                                                        keepdim=True)
    else:
        raise ValueError(f"Unknown scaling mode {mode}")
    return compute_min_mse_scaling(
        data, codebook, axis, H=H, grid_size=grid_size,
        min_factor=min_factor, max_factor=max_factor)
