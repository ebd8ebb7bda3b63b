#!/usr/bin/env bash
# Quadrature scaling sweep of the PyTorch/CUDA port (the role of
# run_integral.sh): N = 10^12 trapezoids over 1..MAXDEV virtual shards of
# one card (or of the CPU with --device=cpu), appending each run's elapsed
# seconds to times.txt.
#
# Usage: launchers/run_integral_torch.sh [--n=N] [--max-dev=N]
#        [--device=cuda|cpu] [--times-file=FILE]
set -euo pipefail
cd "$(dirname "$0")/.."

N=1000000000000
MAXDEV=8
DEVICE=cuda
TIMES=times.txt
for arg in "$@"; do
  case "$arg" in
    --n=*)          N="${arg#*=}" ;;
    --max-dev=*)    MAXDEV="${arg#*=}" ;;
    --device=*)     DEVICE="${arg#*=}" ;;
    --times-file=*) TIMES="${arg#*=}" ;;
    *) echo "unknown arg: $arg" >&2; exit 2 ;;
  esac
done

for np in $(seq 1 "$MAXDEV"); do
  python -m mpi_and_open_mp_tpu_torch.apps.integral "$N" \
    --devices "$np" --device "$DEVICE" --times-file "$TIMES"
done
echo "wrote $TIMES"
