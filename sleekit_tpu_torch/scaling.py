"""Per-channel scaling (port of ``compute_non_saturating_scaling`` from
``sleekit_tpu/scaling.py``; the searches come with the quantizer, ROADMAP
queue 1, item 10)."""

from __future__ import annotations

import torch


def compute_non_saturating_scaling(data: torch.Tensor, codebook,
                                   axis: int = 0) -> torch.Tensor:
    """Smallest per-channel scale with no saturation against the codebook
    range. Requires a mixed-sign codebook."""
    mincode, maxcode = codebook.min(), codebook.max()
    if float(mincode) >= 0 or float(maxcode) <= 0:
        raise ValueError(
            "Codebook should have both negative and positive values.")
    other = tuple(i for i in range(data.ndim) if i != axis)
    mindata = torch.amin(data, dim=other)
    maxdata = torch.amax(data, dim=other)
    scale = torch.maximum(maxdata / maxcode, mindata / mincode)
    return torch.clamp(scale, min=1e-16)
