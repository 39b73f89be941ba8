"""Streaming layer statistics and Hessian utilities (port of
``sleekit_tpu/hessian.py``).

A layer's statistics are a small dataclass of tensors, ``LayerStats``,
updated by :func:`update_stats` on the device of the activations (the
``XᵀX`` product in f32). The inverse-Hessian Cholesky factor comes from
``torch.linalg.cholesky_ex`` and one triangular solve; a failed
factorization (``info > 0``, where JAX's ``cholesky`` yields NaN) gives a
NaN factor, which :func:`hessian_inv_chol_robust` answers with more
dampening. The bias correction, the dampening and the inverse factor
take one matrix (n, n) or a stack (L, n, n) of independent layers (the
batched layer solve), each lane on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sleekit_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LayerStats:
    """Running input statistics of one linear/conv layer: ``mean`` (n,) of
    the input features, ``hessian`` (n, n) the running mean of x xᵀ, and
    ``count`` () the sample columns seen (token positions or conv patches,
    not batches); all f32 on one device."""

    mean: torch.Tensor
    hessian: torch.Tensor
    count: torch.Tensor


def init_stats(n: int, device="cuda") -> LayerStats:
    dev = resolve_device(device)
    return LayerStats(mean=torch.zeros(n, device=dev),
                      hessian=torch.zeros(n, n, device=dev),
                      count=torch.zeros((), device=dev))


def stats_from_numpy(mean, hessian, count=1.0, device="cuda") -> LayerStats:
    """Statistics that arrive as arrays (a reference-layout export, the
    JAX package's), as f32 tensors on ``device``."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return LayerStats(mean=f32(mean), hessian=f32(hessian), count=f32(count))


def update_stats(stats: LayerStats, x: torch.Tensor) -> LayerStats:
    """Fold a batch of samples (samples, features) into the statistics.

    The reference's renormalization: factor = count / (count + added),
    then mean = mean * factor + sum(x) / new_count and
    H = H * factor + xᵀx / new_count, in f32."""
    if x.ndim != 2:
        raise ValueError("update_stats takes a (samples, features) matrix")
    x = x.float()
    new_count = stats.count + x.shape[0]
    factor = stats.count / new_count
    mean = stats.mean * factor + torch.sum(x, dim=0) / new_count
    hessian = stats.hessian * factor
    hessian += (x.T @ x) / new_count
    return LayerStats(mean=mean, hessian=hessian, count=new_count)


def finalize_psum(stats: LayerStats, group) -> LayerStats:
    """Merge the ranks' partial statistics over a data axis: each rank
    accumulated over its own rows, and the global statistics are their
    count-weighted mean. ``group``: the axis's
    :class:`~sleekit_tpu_torch.parallel.distributed.TPGroup` (three
    all-reduces: the count, then ``mean * w`` and ``hessian * w`` with
    ``w = count / total``, 0 where the total is 0); None returns ``stats``
    as they are."""
    if group is None:
        return stats
    total = group.all_reduce(stats.count.clone())
    w = torch.where(total > 0, stats.count / torch.clamp(total, min=1.0),
                    torch.zeros_like(total))
    mean = group.all_reduce(stats.mean * w)
    hessian = group.all_reduce(stats.hessian * w)
    return LayerStats(mean=mean, hessian=hessian, count=total)


# ---- input canonicalization ------------------------------------------------


def prepare_input_linear(x: torch.Tensor) -> torch.Tensor:
    """(..., features) -> (samples, features)."""
    return x.reshape(-1, x.shape[-1])


def prepare_input_conv2d(x: torch.Tensor, kernel_size: Tuple[int, int],
                         dilation: Tuple[int, int] = (1, 1),
                         padding: Tuple[int, int] = (0, 0),
                         stride: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Unfold NCHW conv input into (patches, C*kh*kw) patch rows, feature
    index c*kh*kw + i*kw + j (``F.unfold``'s order)."""
    if x.ndim == 3:
        x = x[None]
    patches = F.unfold(x.float(), kernel_size, dilation=dilation,
                       padding=padding, stride=stride)  # (N, f, L)
    return patches.transpose(1, 2).reshape(-1, patches.shape[1])


def prepare_input_conv1d(x: torch.Tensor, kernel_size: int,
                         dilation: int = 1, padding: int = 0,
                         stride: int = 1) -> torch.Tensor:
    """Unfold NCL conv1d input into (patches, C*k) rows."""
    if x.ndim == 2:
        x = x[None]
    return prepare_input_conv2d(x[..., None], (kernel_size, 1),
                                (dilation, 1), (padding, 0), (stride, 1))


# ---- Hessian transforms ----------------------------------------------------


def random_psd_matrix(seed: int, size: int, rank: int, damp: float = 0.0,
                      device="cuda") -> torch.Tensor:
    """Random Wishart PSD matrix A Aᵀ (A (size, rank) standard normal from
    numpy's ``default_rng(seed)``), plus ``damp`` times each row's 2-norm
    on the diagonal: the synthetic Hessian of tests."""
    dev = resolve_device(device)
    a = np.random.default_rng(seed).standard_normal((size, rank),
                                                    dtype=np.float32)
    a = torch.from_numpy(a).to(dev)
    h = a @ a.T
    return h + torch.diag(damp * torch.linalg.vector_norm(h, dim=1))


def remove_input_bias(H: torch.Tensor,
                      input_mean: torch.Tensor) -> torch.Tensor:
    """Bias correction folded into the Hessian: H - mu muᵀ (the error along
    the input mean goes into the layer bias). H (..., n, n), mean (..., n)."""
    if H.ndim < 2 or input_mean.shape != H.shape[:-1]:
        raise ValueError("remove_input_bias takes H (..., n, n) and mean "
                         "(..., n)")
    return H - input_mean[..., :, None] * input_mean[..., None, :]


def remove_dead_values(H: torch.Tensor, W: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dead input channels (zero diagonal) get the mean diagonal, and their
    weight columns are zeroed. Returns new (H, W)."""
    diag = torch.diagonal(H)
    dead = diag == 0
    H = H.clone()
    H.diagonal().copy_(torch.where(dead, diag.mean(), diag))
    return H, torch.where(dead[None, :], 0.0, W)


def diag_of(H: torch.Tensor) -> torch.Tensor:
    """The diagonal of each matrix of a stack (..., n, n)."""
    return torch.diagonal(H, dim1=-2, dim2=-1)


def dampen(H: torch.Tensor, damp) -> torch.Tensor:
    """GPTQ dampening: H + damp * mean(diag(H)) * I, for each matrix of a
    stack; ``damp`` a number, or a tensor of one per matrix."""
    H = H.clone()
    if isinstance(damp, torch.Tensor):
        damp = damp[..., None]
    diag_of(H).add_(damp * torch.mean(diag_of(H), dim=-1, keepdim=True))
    return H


def hessian_inv_chol(H: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor of H⁻¹ by the flip trick: flip H, take its
    lower Cholesky factor L, invert it (one triangular solve) and flip
    back. All NaN in each matrix whose factorization fails."""
    Hf = H.flip(-2, -1)
    L, info = torch.linalg.cholesky_ex(Hf)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.linalg.solve_triangular(
        L, eye.expand(L.shape), upper=False).flip(-2, -1)


def _not_finite(hinv: torch.Tensor) -> np.ndarray:
    """Whether each matrix of ``hinv`` holds a non-finite entry."""
    return ~torch.isfinite(hinv).all(dim=-1).all(dim=-1).cpu().numpy()


def hessian_inv_chol_robust(H: torch.Tensor, damp: float,
                            max_retries: int = 4):
    """:func:`hessian_inv_chol` of ``dampen(H, damp)``; while a factor is
    not finite (at most ``max_retries`` times) its dampening becomes
    max(10 x, 1e-4), in f32 as the JAX package computes it. Returns
    (Hinv, the multiplier of ``damp`` used): a float for one matrix, a
    list of one a matrix for a stack (L, n, n), where each lane retries
    on its own and keeps the first finite factor it gets (a lane that
    factors at once keeps multiplier 1), as under the JAX package's
    ``vmap``."""
    base = np.float32(damp)
    eff = np.full(H.shape[:-2], base, np.float32)
    hinv = hessian_inv_chol(dampen(H, float(base)))
    bad = _not_finite(hinv)
    for _ in range(max_retries):
        if not bad.any():
            break
        eff[bad] = np.maximum(eff[bad] * np.float32(10.0), np.float32(1e-4))
        if H.ndim == 2:
            hinv = hessian_inv_chol(dampen(H, float(eff)))
        else:
            lanes = torch.from_numpy(np.flatnonzero(bad)).to(H.device)
            hinv[lanes] = hessian_inv_chol(dampen(
                H[lanes], torch.from_numpy(eff[bad]).to(H.device)))
        bad = _not_finite(hinv)
    mults = eff / base
    if H.ndim == 2:
        return hinv, float(mults)
    return hinv, [float(m) for m in mults]
