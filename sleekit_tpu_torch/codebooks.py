"""Codebooks (port of ``sleekit_tpu/codebooks.py``).

``UniformCodebook`` (closed-form round/clip) and ``Codebook`` (sorted
values + bin thresholds, with the NF4 table) for packing and serving. The
training half of ``Codebook`` (``probabilities``, ``centroids``,
``improve``, ``equiprobable``, ``lloyd_max``) comes with the quantizer
(ROADMAP queue 1, item 10).
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
