"""Persisted training metrics — the reference's Comet ML analog.

The port's copy of ``geotrax_tpu/train/runlog.py``: the same files, rows and
columns.

The reference logs every run to Comet ML (reference train/README.md:184-201,
pyproject.toml comet-ml dependency); in a deployment without network access the
equivalents are local artifacts written incrementally next to the
checkpoints, so a killed run still leaves its full metrics history:

  <out>/results.csv     one row per epoch (ultralytics results.csv analog)
  <out>/metrics.jsonl   the same rows as append-only JSONL
  <out>/events.*        TensorBoard scalars (when tensorboard is importable)
"""

from __future__ import annotations

import csv
import json
from pathlib import Path


class RunLogger:
    """Append-only per-epoch metrics writer.

    Every ``log_epoch`` call flushes to disk immediately — the history must
    survive preemption (the checkpoint/resume story's metrics half).
    """

    def __init__(self, out_dir: Path, enable_tensorboard: bool = True):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.csv_path = self.out_dir / "results.csv"
        self.jsonl_path = self.out_dir / "metrics.jsonl"
        self._csv_fields: list[str] | None = None
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.out_dir / "tb"))
            except Exception:  # tensorboard genuinely optional
                self._tb = None

    def log_epoch(self, epoch: int, metrics: dict) -> None:
        row = {"epoch": int(epoch), **{
            k: (float(v) if isinstance(v, (int, float)) else v)
            for k, v in metrics.items()
        }}
        with open(self.jsonl_path, "a") as fh:
            fh.write(json.dumps(row) + "\n")

        if self._csv_fields is None:
            # first epoch fixes the column set (matching rows thereafter)
            self._csv_fields = list(row.keys())
            write_header = not self.csv_path.exists()
            with open(self.csv_path, "a", newline="") as fh:
                w = csv.DictWriter(fh, fieldnames=self._csv_fields,
                                   extrasaction="ignore")
                if write_header:
                    w.writeheader()
                w.writerow(row)
        else:
            with open(self.csv_path, "a", newline="") as fh:
                w = csv.DictWriter(fh, fieldnames=self._csv_fields,
                                   extrasaction="ignore")
                w.writerow(row)

        if self._tb is not None:
            for key, value in row.items():
                if key != "epoch" and isinstance(value, float):
                    self._tb.add_scalar(f"train/{key}", value, epoch)
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
