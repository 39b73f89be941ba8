#!/bin/bash
# The full ablation run on the port (the same loops as
# sleekit_tpu/experiments/run_all.sh): every analysis CLI at codebook
# sizes 8/4/3/2 (= 3/2/1.5/1-bit), then bits, then the results tables.
# Usage: run_all.sh <data_dir> <results_dir> [device]
# <data_dir> is a dump_stats tree; device is cuda (default) or cpu, passed
# as --device to every CLI that solves (results only reads the tables).
set -e
DATA=${1:-data/}
OUT=${2:-results/}
DEV=${3:-cuda}
mkdir -p "$OUT"
# Runnable from anywhere without installing the package.
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}"
PY="python -m sleekit_tpu_torch.experiments"

declare -A SIZES=( [3b]=8 [2b]=4 [1.5b]=3 [1b]=2 )

for b in 3b 2b 1.5b 1b; do
  sz=${SIZES[$b]}
  $PY.correction "$DATA" --codebook-size $sz --device "$DEV" | tee "$OUT/correction_$b.csv"
  $PY.ordering "$DATA" --codebook-size $sz --device "$DEV" | tee "$OUT/ordering_$b.csv"
  $PY.scaling "$DATA" --codebook-size $sz --run-diag --run-obq-aware --run-hessian --device "$DEV" | tee "$OUT/scaling_$b.csv"
  $PY.local_search "$DATA" --codebook-size $sz --device "$DEV" | tee "$OUT/local_search_$b.csv"
  $PY.dampening "$DATA" --codebook-size $sz --device "$DEV" | tee "$OUT/dampening_$b.csv"
  $PY.compare "$DATA" --codebook-size $sz --device "$DEV" | tee "$OUT/compare_$b.csv"
done

$PY.bits "$DATA" --device "$DEV" | tee "$OUT/bits.csv"
$PY.results "$OUT"/compare_*.csv "$OUT"/ordering_*.csv "$OUT"/correction_*.csv
