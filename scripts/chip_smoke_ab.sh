#!/usr/bin/env bash
# Compare two checkouts on one card: runs each one's chip_smoke.py in turns,
# A B B A (A = the other checkout, B = this one), and keeps every run's log.
#
#   scripts/chip_smoke_ab.sh OTHER_CHECKOUT OUT_DIR [chip_smoke arguments]
#
# Make OTHER_CHECKOUT with `git archive <commit> | tar -x -C <dir>` into a
# directory .gitignore lists.  Prints each run's exit code and its kernel,
# serving, cross-device and profile lines; the full logs and smoke records
# are under OUT_DIR/<n>-<which>.
set -u
other=$(cd "$1" && pwd)
mkdir -p "$2"
out=$(cd "$2" && pwd)
shift 2
here=$(cd "$(dirname "$0")/.." && pwd)
n=0
for which in other this this other; do
  n=$((n + 1))
  dir=$here
  [ "$which" = other ] && dir=$other
  (cd "$dir" && python3 chip_smoke.py --out-dir "$out/$n-$which" "$@") \
    > "$out/$n-$which.log" 2>&1
  echo "== run $n ($which, $dir): exit $?"
  grep -E "^kernel |^timing floor|^served|^exact-distance|^cross-device|^profiled batch" \
    "$out/$n-$which.log"
done
