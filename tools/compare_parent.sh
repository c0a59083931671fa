#!/bin/bash
# Time an older checkout (the parent) against this tree on one card, in
# turns: chip_smoke.py parent, new, new, parent, then
# tools/profile_steps.py and tools/kernel_times.py in the same order;
# last, the SASS of both kernel libraries (cuobjdump), for counting a
# kernel's instructions.
#
#   git archive <parent> | tar -x -C build/parent   # build/ is git-ignored
#   bash tools/compare_parent.sh [build/parent] [build/compare]
#
# Run from the root of this tree on the card's machine.  The full logs go
# to the second argument's directory; the summary printed at the end is
# each run's phase E lines for K1, K2 and K4 and its D, G1, G2, G3, V1 and V2
# step rates and E/N, each profile's windows, and each kernel_times run.
PARENT=${1:-build/parent}
OUT=${2:-build/compare}
ROOT=$PWD
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

smoke() {  # $1: parent or new, $2: a or b
  local dir=.
  [ "$1" = parent ] && dir=$PARENT
  (cd "$dir" && python3 chip_smoke.py) > "$OUT/smoke_$1_$2.log" 2>&1
  echo "smoke $1 $2 rc=$?"
}
profile() {
  local dir=.
  [ "$1" = parent ] && dir=$PARENT
  (cd "$dir" && PYTHONPATH=. python "$ROOT/tools/profile_steps.py") \
    > "$OUT/prof_$1_$2.log" 2>&1
  echo "profile $1 $2 rc=$?"
}

kernel_times() {
  local dir=.
  [ "$1" = parent ] && dir=$PARENT
  (cd "$dir" && PYTHONPATH=. python "$ROOT/tools/kernel_times.py") \
    > "$OUT/kt_$1_$2.log" 2>&1
  echo "kernel_times $1 $2 rc=$?"
}

smoke parent a; smoke new a; smoke new b; smoke parent b
profile parent a; profile new a; profile new b; profile parent b
kernel_times parent a; kernel_times new a; kernel_times new b
kernel_times parent b

CUOBJDUMP=/usr/local/cuda/bin/cuobjdump
$CUOBJDUMP -sass build/libqmc_kernels.so > "$OUT/sass_new.txt" 2>&1
$CUOBJDUMP -sass "$PARENT/build/libqmc_kernels.so" \
  > "$OUT/sass_parent.txt" 2>&1

for f in "$OUT"/smoke_*.log; do
  echo "== $f"
  grep '"phase": "E", "kernel": "K[124]' "$f" | sed 's/"card": "[^"]*", //' \
    | cut -c1-330
  grep -o '"phase": "[DGV][123]*", "check": "[DV][^,]*, "card[^}]*step_ms_cuda_events": [0-9.]*' "$f" \
    | sed 's/"card": "[^"]*", //' | cut -c1-300
  grep -o '"phase": "[DGV][123]*", "check": "[^"]*"\|"energy_per_boson": [0-9.]*' "$f" \
    | paste -sd' ' | cut -c1-600
done
for f in "$OUT"/prof_*.log; do
  echo "== $f"
  grep '"window"' "$f" | cut -c1-330
done
for f in "$OUT"/kt_*.log; do
  echo "== $f"
  cut -c1-1200 "$f"
done
