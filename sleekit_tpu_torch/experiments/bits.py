"""Error against bit width, standard GPTQ against Sleekit light (port of
``sleekit_tpu/experiments/bits.py``: the same codebook-size ladder).

  python -m sleekit_tpu_torch.experiments.bits <dir> [--device cpu]
"""

import argparse

from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.experiments.common import (
    add_common_args, corrected, grid_kwargs, iter_layers)
from sleekit_tpu_torch.scaling import compute_scaling, quantize_with_scaling
from sleekit_tpu_torch.solver import quantization_error

# (codebook size, its bits as the reference labels them).
BITS = [(2, 1), (3, 1.5), (4, 2), (5, 2.3), (7, 2.8), (8, 3), (9, 3.2),
        (15, 3.9), (16, 4), (32, 5)]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Analysis of quantization error against codebook size")
    add_common_args(parser)
    args = parser.parse_args(argv)
    gk = grid_kwargs(args)

    header = "Data"
    for _, b in BITS:
        header += f"\tStandard{b}-bit"
    for _, b in BITS:
        header += f"\tSleekitLight{b}-bit"
    print(header)

    for name, W, H, mean in iter_layers(args):
        Hc = corrected(H, mean)
        row = name
        for sz, _ in BITS:
            cb = UniformCodebook(sz, -1, 1)
            sc = compute_scaling(W, cb, H, mode="mse", **gk)
            q = quantize_with_scaling(W, sc, cb, H=H, act_order="diag",
                                      damp=0.01)
            row += f"\t{float(quantization_error(W, q, H))}"
        for sz, _ in BITS:
            cb = UniformCodebook(sz, -1, 1)
            sc = compute_scaling(W, cb, Hc, mode="diag", **gk)
            q = quantize_with_scaling(W, sc, cb, H=Hc, act_order="sqerr",
                                      damp=0.03)
            row += f"\t{float(quantization_error(W, q, Hc))}"
        print(row, flush=True)


if __name__ == "__main__":
    main()
