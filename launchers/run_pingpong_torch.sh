#!/usr/bin/env bash
# Shard-to-shard probe of the PyTorch/CUDA port at two placements (the role
# of run_pingpong.sh): one shard and 8 virtual shards of one card, each a
# size,time CSV and the alpha + beta n fit.
#
# CAVEAT: every shard lives on the one card, so a hop is a device copy and
# one launch, not a fabric; with --devices 1 the CSV measures the card's
# dispatch and copy floor. A fabric needs meshes across cards (ROADMAP
# Queue 1, item 3's last part).
#
# Usage: launchers/run_pingpong_torch.sh [--device=cuda|cpu] [--outdir=DIR]
set -euo pipefail
cd "$(dirname "$0")/.."

DEVICE=cuda
OUTDIR=.
for arg in "$@"; do
  case "$arg" in
    --device=*) DEVICE="${arg#*=}" ;;
    --outdir=*) OUTDIR="${arg#*=}" ;;
    *) echo "unknown arg: $arg" >&2; exit 2 ;;
  esac
done
mkdir -p "$OUTDIR"

python -m mpi_and_open_mp_tpu_torch.apps.pingpong --device "$DEVICE" \
  --devices 1 --out "$OUTDIR/out_single_torch.csv" --fit
python -m mpi_and_open_mp_tpu_torch.apps.pingpong --device "$DEVICE" \
  --devices 8 --out "$OUTDIR/out_mesh_torch.csv" --fit
echo "plot with: python analysis/plot_network.py $OUTDIR/out_single_torch.csv $OUTDIR/out_mesh_torch.csv"
