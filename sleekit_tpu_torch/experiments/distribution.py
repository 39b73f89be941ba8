"""Weight values after each scaling mode (port of
``sleekit_tpu/experiments/distribution.py``; the plot needs matplotlib,
and says so when it is missing: ``--save-data`` writes the values).

  python -m sleekit_tpu_torch.experiments.distribution <dir> \\
      --scaling mse --save-data values.npy [--device cpu]
"""

import argparse

import numpy as np

from sleekit_tpu_torch.experiments.common import (
    add_common_args, iter_layers, make_codebook)
from sleekit_tpu_torch.scaling import (
    apply_scaling, compute_min_mse_scaling, compute_non_saturating_scaling,
    compute_norm_scaling, compute_obq_scaling)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Show the distribution of weights after scaling")
    add_common_args(parser)
    parser.add_argument("--scaling", type=str, default="mse",
                        choices=["norm", "max", "mse", "hessian", "obq"])
    parser.add_argument("--save-data", type=str, default=None)
    parser.add_argument("--save-figure", type=str, default=None)
    args = parser.parse_args(argv)
    cb = make_codebook(args.codebook_size)

    data = []
    for name, W, H, mean in iter_layers(args):
        if args.scaling == "norm":
            sc = compute_norm_scaling(W)
        elif args.scaling == "max":
            sc = compute_non_saturating_scaling(W, cb)
        elif args.scaling == "hessian":
            sc = compute_min_mse_scaling(W, cb, H=H, grid_size=args.grid_size)
        elif args.scaling == "obq":
            sc = compute_obq_scaling(W, cb, 0, H=H, grid_size=args.grid_size)
        else:
            sc = compute_min_mse_scaling(W, cb, grid_size=args.grid_size)
        data.append(apply_scaling(W, sc).cpu().numpy().reshape(-1))

    all_data = np.concatenate(data)
    if args.save_data is not None:
        np.save(args.save_data, all_data)
    if args.save_figure is not None or args.save_data is None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; use --save-data instead")
            return
        plt.title(f"Weights after {args.scaling} scaling")
        plt.xlabel("Value")
        plt.ylabel("Density")
        plt.hist(all_data, 1000, density=True)
        if args.save_figure is not None:
            plt.savefig(args.save_figure)
        else:
            plt.show()


if __name__ == "__main__":
    main()
