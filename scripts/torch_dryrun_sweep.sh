#!/usr/bin/env bash
# The port's dry-run over every (arch x shape x mesh) cell, JOBS cells side
# by side (default 8; a process a cell, since a process holds one default
# process group), the longest first; records under OUT (default
# results/dryrun_torch), the log in OUT/sweep.log, then the table.
# A finished cell's record is read back, not traced again (delete it to
# redo it). ARCHS (default all) names the archs, comma-separated.
#   bash scripts/torch_dryrun_sweep.sh [OUT] [CELL_TIMEOUT_S]
#   ARCHS=zamba2-1.2b,rwkv6-7b bash scripts/torch_dryrun_sweep.sh [OUT] [CELL_TIMEOUT_S]
OUT=${1:-results/dryrun_torch}
LIMIT=${2:-900}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || true
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
start=$(date +%s)
OMP_NUM_THREADS=1 PYTHONPATH=src python -m repro_torch.launch.dryrun --arch "${ARCHS:-all}" --shape all \
    --mesh both --out "$OUT" --cell-timeout "$LIMIT" --jobs "${JOBS:-8}" > "$OUT/sweep.log" 2>&1
rc=$?
echo "sweep exit $rc after $(( $(date +%s) - start )) s"
sed -n '/DRY-RUN SUMMARY/,$p' "$OUT/sweep.log"
PYTHONPATH=src python -m repro_torch.launch.dryrun --table --out "$OUT"
exit $rc
