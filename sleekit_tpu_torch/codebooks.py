"""Codebooks (port of ``UniformCodebook`` from ``sleekit_tpu/codebooks.py``).

Only the uniform codebook is ported: the serving path packs with it. The
table codebooks (NF4, Lloyd-Max) come with the quantizer (ROADMAP queue 1,
item 10).
"""

from __future__ import annotations

import dataclasses

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
