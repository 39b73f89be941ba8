"""Result aggregation (port of ``sleekit_tpu/experiments/results.py``;
numpy only): the reference's headline metric, the geometric mean of
per-layer error ratios against a baseline column, as a percentage change.

Two modes:
  * generic: ``python -m sleekit_tpu_torch.experiments.results file.csv
    ...`` summarizes any experiment TSV against its first numeric column;
  * per-family: ``--families DIR`` runs the reference's per-experiment
    aggregations (ordering, correction, compare, scaling, local search and
    dampening curves per bit width, and the bits-against-width ratio
    table) with the same baseline columns and printouts; ``--plot`` also
    draws them where matplotlib is installed (it says so where it is not).
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, List, Optional

import numpy as np


def read_tsv(path: str) -> Dict[str, List]:
    with open(path) as f:
        rows = list(csv.reader(f, delimiter="\t"))
    header = rows[0]
    cols: Dict[str, List] = {h: [] for h in header}
    for row in rows[1:]:
        for h, v in zip(header, row):
            cols[h].append(v)
    return cols


def numeric_columns(cols: Dict[str, List]) -> Dict[str, np.ndarray]:
    """Columns that parse as floats (by content, not by name - a renamed
    label column can never silently vanish from summaries)."""
    out = {}
    for k, vals in cols.items():
        if not vals:
            continue
        arr = np.full(len(vals), np.nan)
        ok = 0
        for i, v in enumerate(vals):
            try:
                arr[i] = float(v)
                ok += 1
            except ValueError:
                pass
        if ok >= max(1, len(vals) // 2):
            out[k] = arr
    return out


def geomean_ratio(ratios: np.ndarray) -> float:
    """exp(mean(log r)) (ref graph.py:17-18)."""
    ratios = ratios[np.isfinite(ratios) & (ratios > 0)]
    if len(ratios) == 0:
        return float("nan")
    return float(np.exp(np.mean(np.log(ratios))))


def geomean_delta(ratios: np.ndarray) -> float:
    """100 * exp(mean(log r)) - 100."""
    return 100.0 * geomean_ratio(ratios) - 100.0


# ---- per-family aggregation (ref results/graph.py:8-301) ------------------

# family -> (baseline column, [(column, printout label)], plot title,
#            y label, (ymin, ymax), yticks)
FAMILIES = {
    "ordering": (
        "Diag",
        [("DiagErr", "diagonal * error"),
         ("DiagSqErr", "diagonal * squared error")],
        "Impact of GPTQ ordering ({b}-bit); lower is better",
        "Error relative to diagonal ordering (%)",
        (0.5, 1.5), [0.5, 0.6, 0.8, 1.0, 1.2, 1.5, 2.0]),
    "correction": (
        "GPTQ",
        [("GPTQ+BiasCorrection", "plus bias"),
         ("GPTQWithBiasCorrection", "with bias")],
        "Impact of adding bias correction ({b}-bit); lower is better",
        "Error relative to GPTQ alone (%)",
        (0.25, 1.5), [0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 1.2, 1.5]),
    "compare": (
        "Standard",
        [("Correction", "correction"), ("Scaling", "scaling"),
         ("SleekitLight", "sleekit light"), ("SleekitHeavy", "sleekit heavy")],
        "Relative error with Sleekit ({b}-bit); lower is better",
        "Relative error (%)",
        (0.125, 2.0), [0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 1.2, 1.5, 2.0]),
    "scaling": (
        "MSE",
        [("Diag", "diagonal"), ("Hessian", "hessian"),
         ("OBQAware", "exhaustive")],
        "Impact of the scaling method ({b}-bit); lower is better",
        "Error relative to MSE scaling (%)",
        (0.125, 2.0), [0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 1.2, 1.5, 2.0]),
    "local_search": (
        "GPTQ",
        [("GPTQ+LS10", "10 moves"), ("GPTQ+LS100", "100 moves")],
        "Impact of local search ({b}-bit); lower is better",
        "Error relative to no local search (%)",
        (0.25, 1.5), [0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 1.2, 1.5]),
    "dampening": (
        "Damp0.01",
        [("Damp0.001", "0.001"), ("Damp0.003", "0.003"),
         ("Damp0.03", "0.03"), ("Damp0.1", "0.1"), ("Damp0.3", "0.3"),
         ("Damp1.0", "1.0")],
        "Impact of dampening ({b}-bit); lower is better",
        "Error relative to 1% dampening (%)",
        (0.5, 2.0), [0.5, 0.6, 0.8, 1.0, 1.2, 1.5, 2.0]),
}

BITS_SWEEP = ["2.8", "2.3", "2", "1.5", "1"]


def family_curves(path: str, family: str):
    """(sorted ratio curves, geomean ratios) for one family CSV against
    its reference baseline column."""
    base_col, cols, *_ = FAMILIES[family]
    data = numeric_columns(read_tsv(path))
    if base_col not in data:
        raise SystemExit(f"{path}: missing baseline column {base_col}")
    base = data[base_col]
    curves, geo = {}, {}
    for col, label in cols:
        if col not in data:
            continue
        ratios = data[col] / base
        curves[label] = np.sort(ratios)[::-1]
        geo[label] = geomean_ratio(ratios)
    return curves, geo, len(base)


def _plot_family(out_png, title, ylabel, ylim, yticks, n_layers, curves,
                 base_label, percent=True):
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    plt.title(title)
    plt.xlabel("Layers")
    plt.ylabel(ylabel)
    plt.yscale("log")
    plt.xlim(left=0, right=max(n_layers - 1, 1))
    plt.ylim(bottom=ylim[0], top=ylim[1])
    plt.gca().set_yticks([])
    plt.gca().set_yticks([], minor=True)
    plt.gca().set_yticks(yticks)
    if percent:
        plt.gca().set_yticklabels([f"{100 * (t - 1):+.0f}%" for t in yticks])
    else:
        plt.gca().set_yticklabels([f"x{t}" for t in yticks])
    plt.plot(np.ones(n_layers), label=base_label)
    for label, c in curves.items():
        plt.plot(c, label=label)
    plt.legend()
    plt.savefig(out_png)
    plt.clf()
    print(f"  plot -> {out_png}")


def export_family(results_dir: str, family: str, b, plot: bool):
    path = os.path.join(results_dir, f"{family}_{b}b.csv")
    if not os.path.exists(path):
        return
    base_col, cols, title, ylabel, ylim, yticks = FAMILIES[family]
    curves, geo, n = family_curves(path, family)
    parts = ", ".join(f"{label} {100 * g - 100:+.2f}%"
                      for label, g in geo.items())
    print(f"{family.replace('_', ' ').capitalize()} {b}b: {parts}")
    if plot:
        _plot_family(os.path.join(results_dir, f"{family}_{b}b.png"),
                     title.format(b=b), ylabel, ylim, yticks, n, curves,
                     base_col)


def export_bits(results_dir: str, plot: bool):
    """Bits-vs-bitwidth ratio curves: error of each width relative to the
    3-bit standard run (ref graph.py:246-286; factors, not percents)."""
    path = os.path.join(results_dir, "bits.csv")
    if not os.path.exists(path):
        return
    data = numeric_columns(read_tsv(path))
    base_col = "Standard3-bit"
    if base_col not in data:
        raise SystemExit(f"{path}: missing column {base_col}")
    base = data[base_col]
    curves, geo = {}, {}
    for b in BITS_SWEEP:
        col = f"Standard{b}-bit"
        if col not in data:
            continue
        ratios = data[col] / base
        curves[f"{b}-bit"] = np.sort(ratios)[::-1]
        geo[f"{b}b"] = geomean_ratio(ratios)
    parts = ", ".join(f"{k} x{g:.2f}" for k, g in geo.items())
    print(f"Bits: {parts}")
    if plot:
        _plot_family(os.path.join(results_dir, "bits.png"),
                     "Impact of the number of bits; lower is better",
                     "Error relative to 3-bit scaling (%)",
                     (1, 20), [1, 1.5, 2, 3, 5, 7, 10, 15, 20],
                     len(base), curves, "3-bit", percent=False)


def export_all_families(results_dir: str, plot: bool = False):
    """The reference graph.py's main loop: every family x bit-width
    present in the directory (ref graph.py:289-301)."""
    for family in FAMILIES:
        for b in [3, 2, 1.5, 1]:
            b = int(b) if float(b).is_integer() else b
            export_family(results_dir, family, b, plot)
    export_bits(results_dir, plot)


# ---- generic summary -------------------------------------------------------


def summarize(path: str, baseline: Optional[str] = None,
              plot: Optional[str] = None):
    numeric = numeric_columns(read_tsv(path))
    if not numeric:
        print(f"{path}: no numeric columns")
        return
    base_key = baseline or next(iter(numeric))
    base = numeric[base_key]
    print(f"{path} (baseline: {base_key}, {len(base)} layers)")
    curves = {}
    for k, v in numeric.items():
        if k == base_key:
            continue
        ratios = v / base
        curves[k] = np.sort(ratios)[::-1]
        print(f"  {k:24s} {geomean_delta(ratios):+8.2f}%")
    if plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping plot")
            return
        plt.title(f"{path}: error relative to {base_key} (lower is better)")
        plt.xlabel("Layers")
        plt.ylabel(f"Error relative to {base_key}")
        plt.yscale("log")
        plt.plot(np.ones(len(base)), label=base_key)
        for k, c in curves.items():
            plt.plot(c, label=k)
        plt.legend()
        plt.savefig(plot)
        plt.clf()
        print(f"  plot -> {plot}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Aggregate experiment TSVs")
    parser.add_argument("files", nargs="*")
    parser.add_argument("--families", type=str, default=None,
                        help="Results directory: run the per-family "
                             "aggregations (ref results/graph.py) over "
                             "every <family>_<b>b.csv + bits.csv in it")
    parser.add_argument("--baseline", type=str, default=None,
                        help="Baseline column (default: first numeric)")
    parser.add_argument("--plot", action="store_true",
                        help="Also write <file>.png sorted-ratio curves")
    args = parser.parse_args(argv)
    if args.families:
        export_all_families(args.families, plot=args.plot)
    for path in args.files:
        summarize(path, args.baseline,
                  plot=path.rsplit(".", 1)[0] + ".png" if args.plot else None)


if __name__ == "__main__":
    main()
