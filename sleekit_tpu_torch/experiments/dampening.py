"""Dampening sweep, 0.001 to 1.0 (port of
``sleekit_tpu/experiments/dampening.py``).

  python -m sleekit_tpu_torch.experiments.dampening <dir> [--device cpu]
"""

import argparse

from sleekit_tpu_torch.experiments.common import (
    add_common_args, corrected, grid_kwargs, iter_layers, make_codebook)
from sleekit_tpu_torch.scaling import compute_scaling, quantize_with_scaling
from sleekit_tpu_torch.solver import quantization_error

DAMPS = [0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Analysis of the effect of hessian dampening on the "
                    "error")
    add_common_args(parser)
    parser.add_argument("--scaling", type=str, default="mse")
    parser.add_argument("--correct-bias", action="store_true")
    args = parser.parse_args(argv)
    cb = make_codebook(args.codebook_size)
    gk = grid_kwargs(args)

    print("Data\tScaling" + "".join(f"\tDamp{d}" for d in DAMPS))
    for name, W, H, mean in iter_layers(args):
        if args.correct_bias:
            H = corrected(H, mean)
        sc = compute_scaling(W, cb, H, mode=args.scaling, **gk)
        row = f"{name}\t{args.scaling}"
        for damp in DAMPS:
            q = quantize_with_scaling(W, sc, cb, H=H, damp=damp)
            row += f"\t{float(quantization_error(W, q, H))}"
        print(row, flush=True)


if __name__ == "__main__":
    main()
