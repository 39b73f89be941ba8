"""Ordering-heuristic ablation: diag, err and sqerr (port of
``sleekit_tpu/experiments/ordering.py``).

  python -m sleekit_tpu_torch.experiments.ordering <dir> [--device cpu]
"""

import argparse

from sleekit_tpu_torch.experiments.common import (
    add_common_args, corrected, grid_kwargs, iter_layers, make_codebook)
from sleekit_tpu_torch.scaling import compute_scaling, quantize_with_scaling
from sleekit_tpu_torch.solver import quantization_error


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Analysis of the effect of column ordering on the error")
    add_common_args(parser)
    parser.add_argument("--scaling", type=str, default="mse")
    parser.add_argument("--correct-bias", action="store_true")
    args = parser.parse_args(argv)
    cb = make_codebook(args.codebook_size)
    gk = grid_kwargs(args)

    print("Data\tScaling\tDiag\tDiagErr\tDiagSqErr")
    for name, W, H, mean in iter_layers(args):
        if args.correct_bias:
            H = corrected(H, mean)
        sc = compute_scaling(W, cb, H, mode=args.scaling, **gk)
        row = f"{name}\t{args.scaling}"
        for order in ("diag", "err", "sqerr"):
            q = quantize_with_scaling(W, sc, cb, H=H, act_order=order,
                                      damp=args.damp)
            row += f"\t{float(quantization_error(W, q, H))}"
        print(row, flush=True)


if __name__ == "__main__":
    main()
