"""What the probes share: the agreement of a kernel's output with its plain
version, the device time of a CUDA graph's replay, and the card's name."""

from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Dict

import torch
import torch.nn.functional as F


def agreement(got: torch.Tensor, want: torch.Tensor, per_slot: bool = False) -> Dict[str, float]:
    """max-abs error over max |want| and the cosine over everything, in f64.
    With `per_slot` the error is taken slot by slot (the leading dim), each
    over its own slot's largest |want|, and the worst slot's is returned."""
    g, w = got.double().flatten(1 if per_slot else 0), want.double().flatten(1 if per_slot else 0)
    top = w.abs().amax(dim=-1)
    err = (g - w).abs().amax(dim=-1)
    return {"rel_err": float((err / top.clamp_min(1e-30)).max()),
            "cosine": float(F.cosine_similarity(g.flatten(), w.flatten(), dim=0))}


def graph_replay_ms(step: Callable[[], object], replays: int = 20) -> float:
    """Device ms of `step`: run once eagerly (warm-up), captured in one CUDA
    graph, the graph replayed `replays` times; the median CUDA-event time of
    a replay."""
    step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def card_name() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"
