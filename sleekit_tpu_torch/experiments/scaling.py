"""Scaling-mode ablation (port of ``sleekit_tpu/experiments/scaling.py``).

  python -m sleekit_tpu_torch.experiments.scaling <dir> --run-diag \\
      [--run-max --run-diag1 --run-diag3 --run-diag10 --run-hessian \\
      --run-obq-aware --correct-bias] [--device cpu]
"""

import argparse

from sleekit_tpu_torch.experiments.common import (
    add_common_args, corrected, grid_kwargs, iter_layers, make_codebook)
from sleekit_tpu_torch.scaling import compute_scaling, quantize_with_scaling
from sleekit_tpu_torch.solver import quantization_error

MODE_FLAGS = [("max", "Max"), ("diag", "Diag"), ("diag1", "Diag1"),
              ("diag3", "Diag3"), ("diag10", "Diag10"),
              ("hessian", "Hessian"), ("obq", "OBQAware")]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Analysis of the effect of scaling method on the error")
    add_common_args(parser)
    parser.add_argument("--correct-bias", action="store_true",
                        help="Use the bias-corrected hessian")
    for mode, _ in MODE_FLAGS:
        flag = "--run-obq-aware" if mode == "obq" else f"--run-{mode}"
        parser.add_argument(flag, action="store_true",
                            help=f"Run experiments with {mode} mode")
    args = parser.parse_args(argv)
    cb = make_codebook(args.codebook_size)
    gk = grid_kwargs(args)

    modes = ["mse"]
    header = "Data\tMSE"
    for mode, label in MODE_FLAGS:
        attr = "run_obq_aware" if mode == "obq" else f"run_{mode}"
        if getattr(args, attr):
            modes.append(mode)
            header += f"\t{label}"
    print(header)

    for name, W, H, mean in iter_layers(args):
        if args.correct_bias:
            H = corrected(H, mean)
        row = name
        for mode in modes:
            sc = compute_scaling(W, cb, H, mode=mode, **gk)
            q = quantize_with_scaling(W, sc, cb, H=H, damp=args.damp)
            row += f"\t{float(quantization_error(W, q, H))}"
        print(row, flush=True)


if __name__ == "__main__":
    main()
