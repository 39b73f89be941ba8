"""Local-search ablation: 0, 10 and 100 moves (port of
``sleekit_tpu/experiments/local_search.py``).

  python -m sleekit_tpu_torch.experiments.local_search <dir> [--device cpu]
"""

import argparse

from sleekit_tpu_torch.experiments.common import (
    add_common_args, corrected, grid_kwargs, iter_layers, make_codebook)
from sleekit_tpu_torch.scaling import compute_scaling, quantize_with_scaling
from sleekit_tpu_torch.solver import quantization_error


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Analysis of the effect of local search on the error")
    add_common_args(parser)
    parser.add_argument("--scaling", type=str, default="mse")
    parser.add_argument("--correct-bias", action="store_true")
    args = parser.parse_args(argv)
    cb = make_codebook(args.codebook_size)
    gk = grid_kwargs(args)

    print("Data\tScaling\tGPTQ\tGPTQ+LS10\tGPTQ+LS100")
    for name, W, H, mean in iter_layers(args):
        if args.correct_bias:
            H = corrected(H, mean)
        sc = compute_scaling(W, cb, H, mode=args.scaling, **gk)
        row = f"{name}\t{args.scaling}"
        for moves in (0, 10, 100):
            q = quantize_with_scaling(W, sc, cb, H=H, damp=args.damp,
                                      nb_ls_moves=moves)
            row += f"\t{float(quantization_error(W, q, H))}"
        print(row, flush=True)


if __name__ == "__main__":
    main()
