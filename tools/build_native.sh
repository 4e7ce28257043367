#!/bin/bash
# Build the native runtime module -> gemini_seal/_gst_native.so
set -euo pipefail
SCRIPT_DIR="$(cd "$(dirname "$0")" && pwd)"
REPO="$(dirname "$SCRIPT_DIR")"
g++ -O3 -march=native -shared -fPIC -std=c++17 \
    "$REPO/native/gst_native.cpp" -lz \
    -o "$REPO/gemini_seal/_gst_native.so"
echo "built $REPO/gemini_seal/_gst_native.so"
