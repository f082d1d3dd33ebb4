#!/usr/bin/env bash
# CI gate (VERDICT r2 directive #8): one command gates the tree.
# Mirrors the reference's pipeline (build, test, lint, release smoke —
# the reference's .github/workflows/ci.yml:1-40) with this tree's stages:
#   lint -> native build -> CLI smoke -> CPU bench smoke -> full pytest
# Usage: tools/ci.sh [--fast]   (--fast runs a pruned pytest selection)
set -euo pipefail
cd "$(dirname "$0")/.."

FAST=0
[[ "${1:-}" == "--fast" ]] && FAST=1

echo "== lint (tools/lint.py) =="
python tools/lint.py

echo "== native build (make -C native) =="
make -C native -s

echo "== CLI smoke (python -m steroscopic_hardware_tpu --help) =="
JAX_PLATFORMS=cpu python -m steroscopic_hardware_tpu --help > /dev/null
echo "ok"

echo "== bench smoke (CPU backend, one JSON line) =="
BENCH_OUT=$(mktemp)
JAX_PLATFORMS=cpu python bench.py > "$BENCH_OUT"
python -c '
import json, sys
d = json.loads(open(sys.argv[1]).readline())
assert {"metric", "value", "unit", "vs_baseline"} <= set(d), d
assert "error" not in d, d
print("ok:", d["value"], d["unit"], "on", d["detail"]["platform"])
' "$BENCH_OUT"
rm -f "$BENCH_OUT"

echo "== wheel build + install smoke (pyproject) =="
rm -rf build dist ./*.egg-info
python -m pip wheel . -w dist --no-build-isolation --no-deps -q
VENVROOT=$(mktemp -d)
python -m venv "$VENVROOT/venv"
# the dev environment is itself a venv, so --system-site-packages can't
# see jax/numpy; expose the parent site-packages via a .pth instead
PYVER=$(python -c "import sys; print(f'python{sys.version_info.major}.{sys.version_info.minor}')")
python -c "import numpy, os; print(os.path.dirname(os.path.dirname(numpy.__file__)))" \
    > "$VENVROOT/venv/lib/$PYVER/site-packages/_parent_site.pth"
"$VENVROOT/venv/bin/pip" install -q --no-deps --no-index dist/*.whl
JAX_PLATFORMS=cpu "$VENVROOT/venv/bin/steroscopic-hardware-tpu" --help > /dev/null
rm -rf "$VENVROOT"
echo "ok"

echo "== pytest =="
if [[ $FAST == 1 ]]; then
    # the contract core: bit-exactness ladder, SGM, sharding, LZMA
    # interop, runtime/server — skips the slowest SLAM/concurrency soaks
    python -m pytest tests/ -q -x \
        -k "not concurrency and not checkpoint_slam and not multiprocess"
else
    python -m pytest tests/ -q
fi

echo "== CI PASS =="
