#!/usr/bin/env bash
# Time two checkouts' chip_smoke.py on one card in one run, in the order
# parent, change, change, parent, so that the card's drift during the run
# shows as the spread of each side.
#
# Usage, from the root of the repository on a machine with one card:
#
#   bash chip_compare.sh PARENT_DIR CHANGE_DIR OUT_DIR "PARENT_FLAGS" "CHANGE_FLAGS"
#
# PARENT_DIR and CHANGE_DIR each hold a checkout, for example
#
#   mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
#
# (build/ is ignored by git).  Each side runs its own chip_smoke.py from
# its own directory with its flags (empty: every phase; --traversal or
# --lm where that checkout has them) and builds its own kernels.  Each
# run's output goes to OUT_DIR/{parent1,change1,change2,parent2}.log; the
# script prints each run's exit code and last line, and exits non-zero
# when any run did.
set -u
if [ $# -ne 5 ]; then
  echo "usage: $0 PARENT_DIR CHANGE_DIR OUT_DIR PARENT_FLAGS CHANGE_FLAGS" >&2
  exit 2
fi
parent=$(cd "$1" && pwd)
change=$(cd "$2" && pwd)
mkdir -p "$3"
out=$(cd "$3" && pwd)
parent_flags=$4
change_flags=$5
status=0
for run in parent1 change1 change2 parent2; do
  case $run in
    parent*) dir=$parent; flags=$parent_flags ;;
    *) dir=$change; flags=$change_flags ;;
  esac
  start=$(date +%s)
  # shellcheck disable=SC2086  # the flags are words
  (cd "$dir" && python3 chip_smoke.py $flags) > "$out/$run.log" 2>&1
  rc=$?
  echo "$run: rc=$rc in $(( $(date +%s) - start )) s ($dir chip_smoke.py $flags)"
  tail -n 1 "$out/$run.log"
  [ "$rc" -eq 0 ] || status=1
done
exit $status
