"""Decode steps captured as CUDA graphs and replayed, for multi-step bursts.

No JAX counterpart: it stands where `jax.jit` and `lax.scan` do. A burst of
n decode steps (`serve/generate.py::decode_multi_step`,
`serve/paged.py::_paged_multi_step`) replays one captured step n times, so
no Python runs per layer and the host does not wait on the card inside the
burst.

A step is a function of no arguments that reads and writes only fixed
buffers (pools, caches, lengths, tokens, the burst's carry) and returns its
outputs. `StepGraphs.run(key, step)` runs one step:

- the first time a key is seen, the step runs eagerly, for real (it loads
  the kernel library, allocates the shared split counts outside any
  capture and gives cuBLAS its workspace on the capture stream), and is
  then captured over the same buffers; a capture that fails raises;
- later, the captured graph is replayed.

Every buffer the step reads must keep its address for the graph's life: the
C entry points encode their TMA tensor maps on the host from the pointers
of the call, so the capture freezes them. Scratch that a wrapper allocates
inside the step (K3's split partials, K5's and K6's) comes from the graph's
private memory pool, which lives as long as the graph.

The kernels' launch counters are Python increments, which a replay does not
run: each registered counter's (`_kernels.COUNTERS`) change during the
capture is taken back at once and added again at every replay, so the
counters go on counting launches that ran.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, Optional

import torch

from ..ops import _kernels

_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream a device for warm-ups and captures, so that cuBLAS
    allocates its workspace for it once, eagerly."""
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


class StepGraph:
    """One step, run eagerly once and then captured; `replay()` runs it again."""

    def __init__(self, step: Callable[[], Any], device: torch.device,
                 generator: Optional[torch.Generator] = None):
        stream = _capture_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.first = step()  # the warm-up is a real step, counted as launched
        current.wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None and generator is not torch.cuda.default_generators[
                device.index if device.index is not None else torch.cuda.current_device()]:
            self.graph.register_generator_state(generator)
        mark = _kernels.counter_values()
        # thread_local: the server's handler threads may copy to and from
        # the card while the pump thread captures.
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.outputs = step()
        after = _kernels.counter_values()
        mark += [0] * (len(after) - len(mark))  # modules first imported inside the step
        self.deltas = [a - b for a, b in zip(after, mark)]
        for (module, name), value in zip(_kernels.COUNTERS, mark):
            setattr(module, name, value)
        # The shared split counts, held so that they outlive the graph even
        # if a larger launch replaces them in `_kernels`.
        self._held = _kernels._split_counts.get(device)

    def replay(self) -> Any:
        self.graph.replay()
        for (module, name), delta in zip(_kernels.COUNTERS, self.deltas):
            if delta:
                setattr(module, name, getattr(module, name) + delta)
        return self.outputs


class StepGraphs:
    """Captured steps by key. A key names everything that fixes a step's
    shapes, routes and buffers."""

    def __init__(self):
        self._graphs: Dict[Hashable, StepGraph] = {}
        self._buffers: Dict[Hashable, Any] = {}
        self.captures = 0          # graphs captured
        self.capture_seconds = 0.0  # host time of their warm-ups and captures

    def buffers(self, key: Hashable, make: Callable[[], Any]) -> Any:
        """The fixed buffers filed under `key`, made by `make()` on first use."""
        got = self._buffers.get(key)
        if got is None:
            got = self._buffers[key] = make()
        return got

    def run(self, key: Hashable, step: Callable[[], Any], device: torch.device,
            generator: Optional[torch.Generator] = None) -> Any:
        """One step: the replay of `key`'s graph, or (the first time) the step
        run eagerly and captured. Returns the step's outputs (a replay's are
        the graph's fixed output tensors, overwritten by the next replay)."""
        graph = self._graphs.get(key)
        if graph is not None:
            return graph.replay()
        t0 = time.perf_counter()
        graph = self._graphs[key] = StepGraph(step, device, generator)
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        return graph.first

    def pool_bytes(self) -> int:
        """Device memory reserved by the graphs' private pools."""
        pools = {tuple(graph.graph.pool()) for graph in self._graphs.values()}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)
