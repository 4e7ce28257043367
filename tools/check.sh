#!/bin/bash
# One-command verification gate: build the native
# module and the reference oracle, run the FULL test suite (failing loudly
# if any oracle-gated interop test skipped), and self-test the driver
# entry points.  Run before every bench commit.
#
# Usage: bash tools/check.sh [pytest-args...]
set -euo pipefail

cd "$(dirname "$0")/.."

echo "== native module =="
bash tools/build_native.sh

echo "== reference oracle =="
bash tools/build_oracle.sh

echo "== test suite =="
LOG=$(mktemp)
python -m pytest tests/ -q -rs "$@" 2>&1 | tee "$LOG"

if grep -q "oracle not built" "$LOG"; then
  echo "FAIL: oracle-gated interop tests were skipped (oracle missing?)" >&2
  exit 1
fi

echo "== bootstrap e2e (split mode, cosine EvalMod) =="
# the flagship beyond-reference capability refreshes end-to-end in the
# default gate; split-mode compiles are seconds
# post the round-3 85x BSGS compile fix.  Round 5 adds the non-toy
# N=1024/nsp=2/radix=4 shape and the dp-sharded refresh.
GST_BOOTSTRAP_E2E=1 python -m pytest tests/test_bootstrap.py \
  tests/test_bootstrap_sp.py -q \
  -k "split or n1024 or dp_sharded" -m bootstrap_e2e

echo "== driver entry points =="
python __graft_entry__.py

echo "CHECK OK"
