#!/usr/bin/env bash
# Training launcher: wraps `python -m geotrax_tpu_torch.train` with the
# model-variant matrix, fine-tuning from a checkpoint and an output folder.
# Arguments after `--` go to the trainer as they are (--devices N,
# --device cpu, --resume, ...).
#
# Usage:
#   train.sh -d DATASET_DIR [-m yolov8s|yolov8n|...|weights.pt]
#            [-e EPOCHS] [-b BATCH] [-i IMGSZ] [-o OUT_DIR] [-c CFG] [-- TRAINER_ARGS...]
set -euo pipefail

DATA="" MODEL="" EPOCHS="" BATCH="" IMGSZ="" OUT="runs/train" CFG="default"
while getopts "d:m:e:b:i:o:c:" opt; do
  case $opt in
    d) DATA=$OPTARG ;;
    m) MODEL=$OPTARG ;;
    e) EPOCHS=$OPTARG ;;
    b) BATCH=$OPTARG ;;
    i) IMGSZ=$OPTARG ;;
    o) OUT=$OPTARG ;;
    c) CFG=$OPTARG ;;
    *) echo "usage: $0 -d DATASET [-m MODEL] [-e EPOCHS] [-b BATCH] [-i IMGSZ] [-o OUT] [-c CFG] [-- ARGS]"; exit 2 ;;
  esac
done
shift $((OPTIND - 1))
[[ -n "$DATA" ]] || { echo "error: -d DATASET_DIR is required"; exit 2; }

ARGS=(--data "$DATA" --cfg "$CFG" --out "$OUT")
if [[ -n "$MODEL" ]]; then
  case $MODEL in
    yolov8?) ARGS+=(--variant "${MODEL: -1}") ;;   # variant name -> from scratch
    *)       ARGS+=(--model "$MODEL") ;;           # checkpoint path -> fine-tune
  esac
fi
[[ -n "$EPOCHS" ]] && ARGS+=(--epochs "$EPOCHS")
[[ -n "$BATCH"  ]] && ARGS+=(--batch "$BATCH")
[[ -n "$IMGSZ"  ]] && ARGS+=(--imgsz "$IMGSZ")

ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
exec "${PYTHON:-python}" -m geotrax_tpu_torch.train "${ARGS[@]}" "$@"
