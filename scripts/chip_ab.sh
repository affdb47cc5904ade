#!/usr/bin/env bash
# Run chip_smoke.py from two checkouts in turns on one card: other, this,
# this, other, so that the two are compared within one machine and the
# drift of the card's clocks over the run falls on both alike.
#
# Usage, from the root of a checkout, on a machine with the card:
#
#     bash scripts/chip_ab.sh OTHER_DIR [OUT_DIR]
#
# OTHER_DIR is another checkout, e.g. a parent commit unpacked with
# `git archive <commit> | tar -x -C chip_checkout/parent` (chip_checkout/ is
# git-ignored).  Each run's whole output goes to
# OUT_DIR/ab_<n>_<this|other>.log (default: ab_logs/ of this checkout,
# git-ignored); the kernel timings, the profiled calls and the last lines
# of each run are printed.  Exits nonzero if any run fails.
set -u
other=$(cd "$1" && pwd)
this=$(pwd)
out=$(mkdir -p "${2:-ab_logs}" && cd "${2:-ab_logs}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
n=0
for tree in other this this other; do
  n=$((n + 1))
  dir=$this
  [ "$tree" = other ] && dir=$other
  log="$out/ab_${n}_${tree}.log"
  start=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py) > "$log" 2>&1
  rc=$?
  echo "=== run $n ($tree, $dir): exit $rc in $(( $(date +%s) - start )) s"
  grep -E "^\[(k3|k4)\] .*(stage|four stages)|^\[k2\] four stages|^\[k1\] B=2 T=2048|^\[k5\] .*(frames|x100)|^\[build\] (hifigan_(stage_q|imcol)|alias_free_snake): instructions|^\[shapes\] k[124] |one __call__|alias_free_snake_kernel|^\[grad\]|^\[main\] int8 against|^\[ref\] (HiFiGANGenerator|adim)" "$log"
  tail -n 3 "$log"
  [ "$rc" -ne 0 ] && status=1
done
exit $status
