"""Headline experiment: standard GPTQ against correction only, scaling
only, Sleekit light and Sleekit heavy (port of
``sleekit_tpu/experiments/compare.py``: the same flags, TSV schema and
pipeline settings).

  python -m sleekit_tpu_torch.experiments.compare <dir> [--device cpu]
"""

import argparse

from sleekit_tpu_torch.experiments.common import (
    add_common_args, corrected, grid_kwargs, iter_layers, make_codebook)
from sleekit_tpu_torch.hessian import diag_of
from sleekit_tpu_torch.scaling import (
    compute_min_mse_scaling, compute_obq_scaling, quantize_with_scaling)
from sleekit_tpu_torch.solver import quantization_error


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Comparison of standard GPTQ against Sleekit variants")
    add_common_args(parser)
    args = parser.parse_args(argv)
    cb = make_codebook(args.codebook_size)
    gk = grid_kwargs(args)

    print("Data\tStandard\tCorrection\tScaling\tSleekitLight\tSleekitHeavy")
    for name, W, H, mean in iter_layers(args):
        Hc = corrected(H, mean)

        sc = compute_min_mse_scaling(W, cb, **gk)
        std = quantize_with_scaling(W, sc, cb, H=H, act_order="diag",
                                    damp=0.01)
        e_std = quantization_error(W, std, H)
        corr = quantize_with_scaling(W, sc, cb, H=Hc, act_order="diag",
                                     damp=0.01)
        e_corr = quantization_error(W, corr, Hc)

        sc = compute_min_mse_scaling(W, cb, H=diag_of(H), **gk)
        scl = quantize_with_scaling(W, sc, cb, H=H, damp=0.01)
        e_scl = quantization_error(W, scl, H)

        sc = compute_min_mse_scaling(W, cb, H=diag_of(Hc), **gk)
        light = quantize_with_scaling(W, sc, cb, H=Hc, act_order="sqerr",
                                      damp=0.03)
        e_light = quantization_error(W, light, Hc)

        sc = compute_obq_scaling(W, cb, 0, H=Hc, act_order="sqerr",
                                 damp=0.03, **gk)
        heavy = quantize_with_scaling(W, sc, cb, H=Hc, act_order="sqerr",
                                      damp=0.03, nb_ls_moves=100)
        e_heavy = quantization_error(W, heavy, Hc)

        print(f"{name}\t{float(e_std)}\t{float(e_corr)}\t{float(e_scl)}\t"
              f"{float(e_light)}\t{float(e_heavy)}", flush=True)


if __name__ == "__main__":
    main()
