#!/usr/bin/env bash
# Life scaling sweep of the PyTorch/CUDA port (the role of run_life.sh):
# 1..MAXDEV virtual shards of one card (or of the CPU with --device=cpu)
# over the layout, appending each run's elapsed seconds to times.txt, one
# bare-seconds line a shard count; analysis/plot_life.py reads it.
#
# Usage: launchers/run_life_torch.sh [--backend=torch|mpi] [--cfg=FILE]
#        [--max-dev=N] [--layout=row|col|cart] [--device=cuda|cpu]
#        [--times-file=FILE]
#
#   --backend=mpi  hand the other arguments (--device aside) to
#                  launchers/run_life.sh --backend=mpi, the reference MPI
#                  program under mpirun, for a side-by-side baseline.
set -euo pipefail
cd "$(dirname "$0")/.."

BACKEND=torch
CFG=configs/gun_big_500x500.cfg
MAXDEV=8
LAYOUT=row
DEVICE=cuda
TIMES=times.txt
FORWARD=()
for arg in "$@"; do
  case "$arg" in
    --backend=*)    BACKEND="${arg#*=}" ;;
    --cfg=*)        CFG="${arg#*=}"; FORWARD+=("$arg") ;;
    --max-dev=*)    MAXDEV="${arg#*=}"; FORWARD+=("$arg") ;;
    --layout=*)     LAYOUT="${arg#*=}"; FORWARD+=("$arg") ;;
    --device=*)     DEVICE="${arg#*=}" ;;
    --times-file=*) TIMES="${arg#*=}"; FORWARD+=("$arg") ;;
    *) echo "unknown arg: $arg" >&2; exit 2 ;;
  esac
done

case "$BACKEND" in
  mpi)   exec launchers/run_life.sh --backend=mpi "${FORWARD[@]}" ;;
  torch) ;;
  *) echo "--backend is torch or mpi" >&2; exit 2 ;;
esac

for np in $(seq 1 "$MAXDEV"); do
  python -m mpi_and_open_mp_tpu_torch.apps.life "$CFG" --layout "$LAYOUT" \
    --virtual-devices "$np" --devices "$np" --device "$DEVICE" \
    --times-file "$TIMES"
done
echo "wrote $TIMES; plot with: python analysis/plot_life.py $TIMES"
