"""Bias-correction ablation: none, after the optimization, during it
(port of ``sleekit_tpu/experiments/correction.py``).

  python -m sleekit_tpu_torch.experiments.correction <dir> [--device cpu]
"""

import argparse

from sleekit_tpu_torch.experiments.common import (
    add_common_args, corrected, grid_kwargs, iter_layers, make_codebook)
from sleekit_tpu_torch.scaling import compute_scaling, quantize_with_scaling
from sleekit_tpu_torch.solver import quantization_error


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Analysis of the effect of bias correction on the error")
    add_common_args(parser)
    parser.add_argument("--scaling", type=str, default="mse",
                        help="Scaling mode for the experiment")
    args = parser.parse_args(argv)
    cb = make_codebook(args.codebook_size)
    gk = grid_kwargs(args)

    print("Data\tScaling\tGPTQ\tGPTQ+BiasCorrection\tGPTQWithBiasCorrection")
    for name, W, H, mean in iter_layers(args):
        Hc = corrected(H, mean)
        sc = compute_scaling(W, cb, H, mode=args.scaling, **gk)
        gptq = quantize_with_scaling(W, sc, cb, H=H, damp=args.damp)
        with_bias = quantize_with_scaling(W, sc, cb, H=Hc, damp=args.damp)
        e_gptq = quantization_error(W, gptq, H)
        e_after = quantization_error(W, gptq, Hc)
        e_during = quantization_error(W, with_bias, Hc)
        print(f"{name}\t{args.scaling}\t{float(e_gptq)}\t{float(e_after)}\t"
              f"{float(e_during)}", flush=True)


if __name__ == "__main__":
    main()
