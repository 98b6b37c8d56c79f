"""Structured metrics logging (JSONL), replacing the reference's scattered
prints + wandb dependency (SURVEY §5.5).

The port's copies of `MetricsLogger` and `ServingMetrics` from
`vis_zephyr_tpu/utils/metrics.py`, line for line (`tests/test_torch_imports.py`
holds them equal)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


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


class ServingMetrics:
    """Per-request serving observability: TTFT / TPOT histograms + counters.

    Thread-safe enough for the batcher's use (record_request is called from
    the pump thread only). Histograms are fixed log-spaced ms buckets;
    `summary()` reports count/mean and approximate p50/p90/p99 from them.
    Pass a `MetricsLogger` to also emit one JSONL row per finished request.
    """

    BUCKETS_MS = (1, 2.5, 5, 10, 25, 50, 100, 200, 400, 800, 1600, 3200,
                  6400, 12800, float("inf"))

    def __init__(self, logger: Optional[MetricsLogger] = None):
        self.logger = logger
        self._hist: Dict[str, list] = {}
        self._sum: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self.requests = 0
        self.tokens_out = 0
        # Speculative decoding (prompt-lookup) accounting.
        self.spec_proposed = 0
        self.spec_accepted = 0
        # Lazy-allocation pool-pressure preemption (PagedBatcher lazy_alloc).
        self.preempt_swap_out = 0
        self.preempt_swap_in = 0

    def observe(self, name: str, value_ms: float) -> None:
        hist = self._hist.setdefault(name, [0] * len(self.BUCKETS_MS))
        for i, edge in enumerate(self.BUCKETS_MS):
            if value_ms <= edge:
                hist[i] += 1
                break
        self._sum[name] = self._sum.get(name, 0.0) + value_ms
        self._count[name] = self._count.get(name, 0) + 1

    def record_request(self, request_id: int, ttft_ms: float, tpot_ms: float,
                       n_tokens: int) -> None:
        self.requests += 1
        self.tokens_out += n_tokens
        self.observe("ttft_ms", ttft_ms)
        if n_tokens > 1:
            self.observe("tpot_ms", tpot_ms)
        if self.logger:
            self.logger.log(
                self.requests, request_id=request_id,
                ttft_ms=round(ttft_ms, 2), tpot_ms=round(tpot_ms, 3),
                tokens=n_tokens,
            )

    def record_speculation(self, proposed: int, accepted: int) -> None:
        """One verify step's proposal outcome for one slot (the batcher's
        prompt-lookup speculation, `serve/batching.py::_step_verify`)."""
        self.spec_proposed += proposed
        self.spec_accepted += accepted

    def _quantile(self, name: str, q: float) -> Optional[float]:
        hist = self._hist.get(name)
        n = self._count.get(name, 0)
        if not hist or not n:
            return None
        target = q * n
        acc = 0
        for i, c in enumerate(hist):
            acc += c
            if acc >= target:
                return float(self.BUCKETS_MS[i] if i < len(hist) - 1
                             else self.BUCKETS_MS[-2])
        return float(self.BUCKETS_MS[-2])

    def summary(self) -> Dict[str, Dict]:
        out = {"requests": self.requests, "tokens_out": self.tokens_out}
        if self.spec_proposed:
            out["speculation"] = {
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance_rate": round(self.spec_accepted / self.spec_proposed, 4),
            }
        if self.preempt_swap_out:
            out["preemption"] = {
                "swap_out": self.preempt_swap_out,
                "swap_in": self.preempt_swap_in,
            }
        for name, n in self._count.items():
            out[name] = {
                "count": n,
                "mean": round(self._sum[name] / n, 3),
                "p50": self._quantile(name, 0.50),
                "p90": self._quantile(name, 0.90),
                "p99": self._quantile(name, 0.99),
            }
        return out
