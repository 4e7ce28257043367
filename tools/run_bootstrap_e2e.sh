#!/bin/bash
# Run the full CKKS bootstrap end-to-end refresh test (opt-in: it chains
# ~6 deep jitted programs; minutes of XLA compile on a single host core).
set -e
cd "$(dirname "$0")/.."
export GST_BOOTSTRAP_E2E=1
exec python -m pytest tests/test_bootstrap.py -q "$@"
