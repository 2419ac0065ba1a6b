"""Metric loggers: CSV and console.

Port of ``instant_nsr_pl_tpu/utils/loggers.py`` (the reference wires a CSV
logger, launch.py:86-91, and ships an unwired console logger,
utils/loggers.py:9-41). The TensorBoard logger comes with a later slice.
"""

from __future__ import annotations

import csv
import os
import re
import time


class CSVLogger:
    """Appends one row per call to ``<log_dir>/<name>``, rewriting the file
    so new metric columns get a header."""

    def __init__(self, log_dir, name="metrics.csv"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, name)
        self._fields = ["step"]
        self._rows = []

    def log_metrics(self, metrics: dict, step: int):
        row = {"step": step}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
            if k not in self._fields:
                self._fields.append(k)
        self._rows.append(row)
        self._flush()

    def _flush(self):
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            w.writeheader()
            w.writerows(self._rows)

    def finalize(self):
        self._flush()


class ConsoleLogger:
    """Prints a filtered metrics line every ``interval`` steps."""

    def __init__(self, log_keys=(), interval=100):
        self.patterns = [re.compile(k) for k in log_keys]
        self.interval = interval
        self._t0 = time.time()
        self._last_step = 0

    def log_metrics(self, metrics: dict, step: int):
        if self.interval and step % self.interval != 0:
            return
        shown = {
            k: v
            for k, v in metrics.items()
            if not self.patterns or any(p.search(k) for p in self.patterns)
        }
        dt = time.time() - self._t0
        rate = (step - self._last_step) / dt if dt > 0 else 0.0
        self._t0, self._last_step = time.time(), step
        parts = " ".join(f"{k}={float(v):.4g}" for k, v in shown.items())
        print(f"[step {step}] {parts} ({rate:.1f} it/s)", flush=True)

    def finalize(self):
        pass
