#!/usr/bin/env bash
# Recursive checkpoint export: every *.pt under a folder becomes a .npz
# beside it (batch norm folded) through the port's converter.
#
# Usage: export.sh CHECKPOINT_DIR [--bf16] [--check IMGSZ] [--device cpu]
set -euo pipefail

DIR=${1:?usage: export.sh CHECKPOINT_DIR [--bf16] [--check IMGSZ] [--device DEVICE]}
shift
ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"

find "$DIR" -name '*.pt' | sort | while read -r ckpt; do
  out="${ckpt%.pt}.npz"
  echo "exporting $ckpt -> $out"
  "${PYTHON:-python}" -m geotrax_tpu_torch.models.convert "$ckpt" -o "$out" "$@"
done
