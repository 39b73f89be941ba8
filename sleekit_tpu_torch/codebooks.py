"""Codebooks (port of ``sleekit_tpu/codebooks.py``).

``UniformCodebook`` (closed-form round/clip) and ``Codebook`` (sorted
values + bin thresholds, with the NF4 table) for packing and serving, and
the training half of ``Codebook`` (``probabilities``, ``entropy``,
``mse``, ``centroids``, ``remove_unused``, ``improve``, ``random``,
``equiprobable`` and ``lloyd_max``) for the quantizer.

A codebook's values and thresholds live on the CPU; its metrics and
training steps run on the device of the data they are given. Bin sums are
segment sums over the data ordered by bin (a stable sort keeps each bin's
elements in their order), so they are deterministic on CUDA too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def _index_dtype(codebook_size: int) -> torch.dtype:
    """Smallest integer dtype able to index the codebook."""
    return torch.uint8 if codebook_size <= 2 ** 8 else torch.int32


@dataclasses.dataclass(frozen=True)
class UniformCodebook:
    """Evenly spaced codebook over ``[min_val, max_val]`` with closed-form
    round/clip quantization (round half to even, as ``jnp.round``)."""

    codebook_size: int
    min_val: float
    max_val: float

    def __post_init__(self):
        if self.codebook_size < 2 or not self.min_val < self.max_val:
            raise ValueError("a uniform codebook needs >= 2 values over a "
                             "non-empty range")

    def __len__(self) -> int:
        return self.codebook_size

    @property
    def values(self) -> torch.Tensor:
        # The same affine grid as quantize_value, so the two agree exactly.
        idx = torch.arange(self.codebook_size, dtype=torch.float32)
        return idx * self.scale + self.zero

    def min(self) -> float:
        return self.min_val

    def max(self) -> float:
        return self.max_val

    @property
    def scale(self) -> float:
        return (self.max_val - self.min_val) / (self.codebook_size - 1)

    @property
    def zero(self) -> float:
        return self.min_val

    def _to_grid(self, data: torch.Tensor) -> torch.Tensor:
        # Divide by a device tensor: CUDA division by a Python number
        # multiplies by its reciprocal (not always the same last bit).
        return (data - self.zero) / data.new_full((), self.scale)

    def _index(self, data: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(self._to_grid(data)), 0,
                           self.codebook_size - 1)

    def quantize_index(self, data: torch.Tensor) -> torch.Tensor:
        """Nearest codebook index, in the smallest integer dtype."""
        return self._index(data).to(_index_dtype(self.codebook_size))

    def quantize_value(self, data: torch.Tensor) -> torch.Tensor:
        """Nearest codebook value."""
        return self._index(data) * self.scale + self.zero

    def quantize_up(self, data: torch.Tensor) -> torch.Tensor:
        """The next codebook value above, saturating at the top."""
        idx = torch.clamp(torch.round(self._to_grid(data) + 1.0), 1,
                          self.codebook_size - 1)
        return idx * self.scale + self.zero

    def quantize_down(self, data: torch.Tensor) -> torch.Tensor:
        """The next codebook value below, saturating at the bottom."""
        idx = torch.clamp(torch.round(self._to_grid(data) - 1.0), 0,
                          self.codebook_size - 2)
        return idx * self.scale + self.zero

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        return self.quantize_value(data)


@dataclasses.dataclass(frozen=True, eq=False)
class Codebook:
    """Arbitrary scalar codebook: sorted ``values`` (k,) and bin
    ``thresholds`` (k-1,), both f32 on the CPU. A value quantizes to the
    bin it falls in: the count of thresholds <= it."""

    values: torch.Tensor
    thresholds: torch.Tensor

    @staticmethod
    def create(values: Sequence[float] | np.ndarray,
               limits: Optional[Sequence[float] | np.ndarray] = None
               ) -> "Codebook":
        """Sorts ``values`` and takes the midpoints as thresholds, unless
        ``limits`` gives the thresholds (values then stay in their
        order)."""
        vals = np.asarray(values, dtype=np.float32)
        if limits is not None:
            thr = np.asarray(limits, dtype=np.float32)
        else:
            vals = np.sort(vals)
            thr = (vals[:-1] + vals[1:]) / 2
        cb = Codebook(torch.from_numpy(vals.copy()),
                      torch.from_numpy(np.ascontiguousarray(thr)))
        cb.check()
        return cb

    def check(self) -> None:
        """Raises ``ValueError`` unless the values are finite and strictly
        increasing and each threshold lies, increasing, between its two
        values."""
        vals = self.values.numpy()
        thr = self.thresholds.numpy()
        ok = (vals.ndim == 1 and vals.size > 0 and np.isfinite(vals).all()
              and (vals[1:] > vals[:-1]).all() and thr.ndim == 1
              and thr.size == vals.size - 1 and np.isfinite(thr).all())
        if ok and thr.size:
            ok = bool((thr[1:] > thr[:-1]).all() and (thr >= vals[:-1]).all()
                      and (thr <= vals[1:]).all())
        if not ok:
            raise ValueError("inconsistent codebook values / thresholds")

    def __len__(self) -> int:
        return int(self.values.shape[0])

    def min(self) -> float:
        return float(self.values[0])

    def max(self) -> float:
        return float(self.values[-1])

    def quantize_index(self, data: torch.Tensor) -> torch.Tensor:
        """Bin index (``searchsorted(thresholds, side="right")``), in the
        smallest integer dtype."""
        thr = self.thresholds.to(data.device)
        idx = torch.searchsorted(thr, data.float().contiguous(), right=True)
        return idx.to(_index_dtype(len(self)))

    def _take(self, table: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        return table.to(data.device)[self.quantize_index(data).long()]

    def quantize_value(self, data: torch.Tensor) -> torch.Tensor:
        return self._take(self.values, data)

    def quantize_up(self, data: torch.Tensor) -> torch.Tensor:
        """The value one above the containing bin, saturating at the top."""
        return self._take(torch.cat([self.values[1:], self.values[-1:]]),
                          data)

    def quantize_down(self, data: torch.Tensor) -> torch.Tensor:
        """The value one below the containing bin, saturating at the
        bottom."""
        return self._take(torch.cat([self.values[:1], self.values[:-1]]),
                          data)

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        return self.quantize_value(data)

    # ---- metrics -----------------------------------------------------

    def _bins(self, data: torch.Tensor):
        """(flat f32 data, bin indices int64, per-bin counts int64)."""
        flat = data.reshape(-1).float()
        idx = self.quantize_index(flat).long()
        return flat, idx, torch.bincount(idx, minlength=len(self))

    def probabilities(self, data: torch.Tensor) -> torch.Tensor:
        """Empirical codeword probabilities over the flattened data."""
        flat, _, counts = self._bins(data)
        return counts.float() / flat.new_full((), flat.shape[0])

    def entropy(self, data: torch.Tensor) -> torch.Tensor:
        """Empirical entropy in bits."""
        p = self.probabilities(data)
        return -torch.sum(torch.where(
            p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0))

    def mse(self, data: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.square(data - self.quantize_value(data)))

    def centroids(self, data: torch.Tensor) -> torch.Tensor:
        """Per-bin data centroid. An empty first or last bin nudges past its
        boundary threshold, an empty interior bin takes its thresholds'
        midpoint."""
        flat, idx, counts = self._bins(data)
        # Each bin's elements in their order, one segment a bin.
        ordered = flat[torch.argsort(idx, stable=True)]
        sums = torch.segment_reduce(ordered, "sum", lengths=counts)
        thr = self.thresholds.to(flat.device)
        interior = [(thr[:-1] + thr[1:]) / 2] if len(self) > 2 else []
        fallback = torch.cat([thr[:1] - 1e-6, *interior, thr[-1:] + 1e-6])
        counts = counts.float()
        return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                           fallback)

    # ---- training ----------------------------------------------------

    def remove_unused(self, data: torch.Tensor) -> "Codebook":
        """Drops codewords with no data; the surviving boundaries keep their
        thresholds."""
        counts = self.probabilities(data).cpu().numpy()
        if not (counts == 0).any():
            return self
        vals, thr = self.values.numpy(), self.thresholds.numpy()
        new_thr = thr[counts[:-1] != 0]
        if counts[-1] == 0:
            new_thr = new_thr[:-1]
        return Codebook.create(vals[counts != 0], new_thr)

    def improve(self, data: torch.Tensor,
                lagrange_mult: float = 0.0) -> "Codebook":
        """One Lloyd-Max round: thresholds to the (entropy-penalized)
        midpoints, values to the centroids."""
        cb = self
        if lagrange_mult != 0.0:
            cb = cb.remove_unused(data)
            v = cb.values
            logp = -torch.log2(cb.probabilities(data)).cpu()
            penalty = (logp[1:] - logp[:-1]) / (v[1:] - v[:-1])
            thr = (v[:-1] + v[1:]) / 2 + lagrange_mult * penalty / 2
            # The penalty may break monotonicity: sort it back.
            thr = torch.sort(thr).values
        else:
            v = cb.values
            thr = (v[:-1] + v[1:]) / 2
        new_vals = Codebook(cb.values, thr).centroids(data)
        return Codebook.create(new_vals.cpu().numpy(), thr.numpy())

    def close_to(self, other: "Codebook", tol: float = 1e-6) -> bool:
        if len(self) != len(other):
            return False
        rng = max(float(self.values.max() - self.values.min()), 1e-10)
        return bool(torch.allclose(self.values, other.values, atol=tol * rng))

    @staticmethod
    def random(data, codebook_size: int, seed: int = 0) -> "Codebook":
        """Codebook of distinct data values drawn at random (numpy's
        ``default_rng(seed).choice`` over the sorted distinct values)."""
        values = torch.unique(_flat(data))
        rng = np.random.default_rng(seed)
        pick = rng.choice(values.numel(), min(codebook_size, values.numel()),
                          replace=False)
        return Codebook.create(
            values[torch.from_numpy(pick).to(values.device)].cpu().numpy())

    @staticmethod
    def equiprobable(data, codebook_size: int) -> "Codebook":
        """Equal-mass bins of the sorted data (``np.array_split``'s sizes),
        thresholds between neighbouring bins, values their centroids."""
        flat = torch.sort(_flat(data)).values
        n = flat.numel()
        sizes = [n // codebook_size + (i < n % codebook_size)
                 for i in range(codebook_size)]
        sizes = [s for s in sizes if s > 0]
        ends = np.cumsum(sizes)
        edges = flat[torch.from_numpy(
            np.stack([ends[:-1] - 1, ends[:-1]])).to(flat.device)].cpu()
        limits = ((edges[0] + edges[1]) / 2).numpy()
        means = torch.segment_reduce(flat, "mean", lengths=torch.tensor(
            sizes, device=flat.device))
        cb = Codebook.create(means.cpu().numpy(), limits)
        return Codebook.create(cb.centroids(flat).cpu().numpy(), limits)

    @staticmethod
    def uniform(codebook_size: int, min_val: float,
                max_val: float) -> "Codebook":
        if not min_val <= max_val:
            raise ValueError("min_val must not exceed max_val")
        return Codebook.create(np.linspace(min_val, max_val, codebook_size))

    @staticmethod
    def nf4() -> "Codebook":
        """The NormalFloat4 table (QLoRA's 16 constants)."""
        return Codebook.create(_NF4_VALUES)


def _flat(data) -> torch.Tensor:
    """Data (a tensor, on its device, or an array, on the CPU) as a flat
    f32 tensor."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).float()
    return torch.from_numpy(np.asarray(data, np.float32).reshape(-1).copy())


def lloyd_max(data, codebook_size: int, lagrange_mult: float = 0.0,
              max_iter: int = 100, tol: float = 1e-6,
              random_init: bool = False, sample_count: Optional[int] = None,
              seed: int = 0) -> Codebook:
    """Scalar Lloyd-Max codebook training, on the data's device.

    With ``sample_count``, trains on ``codebook_size * sample_count`` data
    values drawn without replacement (numpy's ``default_rng(seed)``, the
    JAX package's draw). Starts from equal-mass bins (or, with
    ``random_init``, random data values) and stops when the values move
    less than ``tol`` of their range."""
    flat = _flat(data)
    if sample_count is not None:
        nsamples = codebook_size * sample_count
        if nsamples < flat.numel():
            rng = np.random.default_rng(seed)
            pick = rng.choice(flat.numel(), nsamples, replace=False)
            flat = flat[torch.from_numpy(pick).to(flat.device)]
    flat = torch.sort(flat).values
    if random_init:
        codebook = Codebook.random(flat, codebook_size, seed=seed)
    else:
        codebook = Codebook.equiprobable(flat, codebook_size)
    for _ in range(max_iter):
        new_codebook = codebook.improve(flat, lagrange_mult)
        if new_codebook.close_to(codebook, tol):
            break
        codebook = new_codebook
    return codebook


# NormalFloat4 constants (the public QLoRA datatype).
_NF4_VALUES = [
    -1.0,
    -0.6961928009986877,
    -0.5250730514526367,
    -0.39491748809814453,
    -0.28444138169288635,
    -0.18477343022823334,
    -0.09105003625154495,
    0.0,
    0.07958029955625534,
    0.16093020141124725,
    0.24611230194568634,
    0.33791524171829224,
    0.44070982933044434,
    0.5626170039176941,
    0.7229568362236023,
    1.0,
]
