"""Shared harness of the ablation CLIs (port of
``sleekit_tpu/experiments/common.py``).

The reference's experiment skeleton: argparse flags, the walk over a
``<root>/<layer>/{weight,hessian,mean}.npy`` tree (the layout
``dump_stats`` writes), one TSV row a layer on stdout, so that result
files keep the reference's schemas. Each CLI runs on ``--device``: the
CUDA device unless ``--device cpu`` is given, never falling back to the
CPU. The JAX package's ``honor_platform_env`` (which pins JAX's platform
from ``JAX_PLATFORMS``) has no counterpart here: ``--device`` picks the
device.
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, List, Tuple

import numpy as np
import torch

from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.hessian import remove_dead_values, remove_input_bias


def add_common_args(parser: argparse.ArgumentParser,
                    codebook_size: int = 4) -> None:
    parser.add_argument("dir", type=str,
                        help="Directory containing the weights")
    parser.add_argument("--codebook-size", type=int, default=codebook_size,
                        help="Size of the codebook to use")
    parser.add_argument("--damp", type=float, default=0.01,
                        help="Hessian dampening")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    gp = parser.add_argument_group("Optimization")
    gp.add_argument("--grid-size", type=int, default=100,
                    help="Grid size for error minimization")
    gp.add_argument("--min-factor", type=float, default=0.05,
                    help="Minimum scaling factor for error minimization")
    gp.add_argument("--max-factor", type=float, default=1.0,
                    help="Maximum scaling factor for error minimization")


def grid_kwargs(args) -> dict:
    """The grid search's flags as keyword arguments."""
    return dict(grid_size=args.grid_size, min_factor=args.min_factor,
                max_factor=args.max_factor)


def find_layer_dirs(root: str) -> List[str]:
    """Every directory holding a {weight,hessian,mean}.npy triple, in
    sorted walk order."""
    out = []
    for dirpath, _, filenames in sorted(os.walk(root)):
        if {"weight.npy", "hessian.npy", "mean.npy"} <= set(filenames):
            out.append(dirpath)
    return out


def load_layer(path: str, device) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """One layer's artifacts as f32 tensors on ``device``, (W (out, -1),
    H, mean), with dead input columns repaired
    (:func:`~sleekit_tpu_torch.hessian.remove_dead_values`)."""
    def load(name):
        return torch.from_numpy(np.load(os.path.join(path, f"{name}.npy"))
                                .astype(np.float32)).to(device)

    weight = load("weight")
    H, W = remove_dead_values(load("hessian"),
                              weight.reshape(weight.shape[0], -1))
    return W, H, load("mean")


def corrected(H: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    return remove_input_bias(H, mean)


def make_codebook(size: int) -> UniformCodebook:
    """The experiments' codebook: symmetric uniform over [-1, 1]."""
    return UniformCodebook(size, -1.0, 1.0)


def iter_layers(args) -> Iterator[Tuple[str, torch.Tensor, torch.Tensor,
                                        torch.Tensor]]:
    """(name relative to ``args.dir``, W, H, mean) of every layer, on
    ``args.device``."""
    device = resolve_device(args.device)
    roots = find_layer_dirs(args.dir)
    if not roots:
        raise SystemExit(f"no layer artifacts under {args.dir}")
    for root in roots:
        yield (os.path.relpath(root, args.dir),) + load_layer(root, device)
