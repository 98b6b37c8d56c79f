"""Structured metrics logging (JSONL), replacing the reference's scattered
prints + wandb dependency (SURVEY §5.5).

The port's copy of `MetricsLogger` from `vis_zephyr_tpu/utils/metrics.py`;
`ServingMetrics` comes with the serving features (ROADMAP.md, Queue A
step 10)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics stream with a console echo."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, **metrics) -> None:
        row = {"step": step, "time": time.time()}
        row.update({k: (float(v) if hasattr(v, "item") else v) for k, v in metrics.items()})
        if self._f:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        if self.echo:
            parts = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()
                if k not in ("time",)
            )
            print(parts, flush=True)

    def close(self) -> None:
        if self._f:
            self._f.close()
