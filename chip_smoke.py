"""GPU smoke run of the PyTorch port's serving paths: one request at a time
over a dense cache, and continuous batching over int8 KV-fused page pools,
each with bf16 weights, int8 weights (`--load-8bit`) and int4 weights
(`--load-4bit`), each with prompt-lookup speculation (`--lookahead`) and
each with multi-step bursts replayed as CUDA graphs (`--multi-step`);
the writefirst paged decode step; the fused int8 MLP probe; the trainer,
stage 1 and stage 2; and the batched-head and slot-grouped attention
probes.

    python3 chip_smoke.py [--seed N] [--max-new-tokens N] [--profile] [--phases a,b]

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; exits non-zero on a machine without a card. Phases:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds `vis_zephyr_tpu_torch/csrc/*.cu` into the ignored
             `vis_zephyr_tpu_torch/build/`;
3. K1      — flash_fwd (wgmma + TMA: its SASS must hold HGMMA and UTMALDG)
             against its plain version (f32 from the same bf16 inputs, one
             batch row at a time): causal T=S 256 and 2048, non-causal, B=2
             with right-padded keys plus a row that has no valid key, the
             trainer's B=8, T=S=2048 with each row's keys padded to another
             length, a 64-row half tile (T=S=192), non-causal T=128 S=320 and
             GQA group 1; output max-abs <= 2e-2, logsumexp max-abs <= 1e-2,
             keyless rows exactly 0 with l = 0 and m = NEG_INF; timed at B=1,
             T=S 256 and 2048 and at the trainer's shape; then K7
             (dK, dV) and K8 (dQ) (wgmma + TMA: each one's SASS must hold
             HGMMA and UTMALDG; registers and spills from cuobjdump
             -res-usage) in K1's first four cases, at the trainer's B=8,
             T=S=2048 with right-padded keys, at B=16 T=S=320 and at
             non-causal T=128 S=320, against
             `flash_attention_bwd_plain` in f32 on the same bf16 inputs and
             K1's m and l, one batch row at a time: per tensor max-abs <=
             1e-2 of its largest value and cosine >= 0.9999, dQ exactly 0 on
             rows without a key and dK = dV = 0 on invalid keys; kernel (per
             call and on the device alone), plain, bound and the backward of
             `scaled_dot_product_attention` at T=S 256 and 2048 and at B=8;
4. K2      — dense_cache_append's two entries against their plain versions,
             bit-exact: the copy entry (rows already rotated, the JAX
             contract) and the rope entry (K rotated in the kernel, what the
             dense-cache forward calls), at the decode step's shape (T=1), a
             clamped tail, and chunked admission's (B=1, T=256 into a scratch
             cache, one chunk ending at the cache's end); at the decode shape
             and a chunk: per call (median of 20 CUDA-event runs), on the
             device (a CUDA-graph replay) and issued back to back, beside the
             plain version, the bound, `index_put_` of the rotated rows and
             the route taken before (eager apply_rope + the copy entry);
5. K3      — paged_attn_decode's SASS must hold HMMA (mma.sync), UTMALDG (the
             pages by TMA) and UBLKCP (the scales by bulk copy); registers and
             stack printed; then against its plain version at B=32, Hq=32,
             Hkv=8, D=128, page 128, 16 pages per slot, a shuffled page table
             and lengths that include 0, 1, 128, 129 and 2048: bf16 split,
             int8 split and int8 fused pools, each with and without the
             self-term, a windowed case, a two-row (S=2) case and NaN rows
             past `length`; per slot, max-abs error <= 1e-2 of the slot's
             largest value; exact zeros where no key is valid; the window's
             edge told from 511 and 513; the split plan's cases (one slot of
             2048 in 16 splits, one of 200, one of 2048 with a window of
             1000, 128 slots of 640 without a split, slots with fewer pages
             than splits, S = 9 with a window whose edge crosses a page
             between the tile's rows) and two calls at a split shape equal
             bit for bit; device times at the decode shape and at 2048
             tokens; then without the self-term at
             S = 1 to 9 query rows per slot (the verify shape; S = 9 is two
             row tiles) over int8 fused pools of 60 to 800 tokens, times
             (per call and on the device) and bound per S, bf16 split pools at
             S = 5 with a window; then
             rows 7 and 8's contracts: the single-row entry `paged_attention`
             over bf16 and int8 split pools with and without the self-term,
             with and without a window of 512, and
             `paged_attention_fa(fold_heads=False)` at S = 1 and 5, each per
             slot against the plain version; times at served lengths;
6. K4      — paged_kv_rows against its plain version at L=32, B=32 with
             inactive slots on the trash page: bf16 and int8, split and
             fused; whole pools and scales bit-exact, page 0 included (the
             last row in launch order wins there, in both); timed per call,
             on the device and issued back to back; then its absolute-page
             entry: `paged_kv_update_layer` at B=32, S = 1 to 9 rows a slot
             from a page table (rows sharing a page, rows forced onto the
             trash page, inactive slots) and on strided views, and the JAX
             contract paged_kv_update at L = 1 and 2, over the same four pool
             forms, bit-exact; timed at the verify step's form (int8 fused,
             S = 5) beside the route taken before (S single-row calls);
7. K5      — quant_matmul_int8 (wgmma, weights by TMA: its SASS must hold
             HGMMA and UTMALDG; its PRMT, LOP3 and I2F counts, registers and
             stack printed) against its plain version at every (K, N) of
             an int8 projection (decoder q/o, k/v, gate/up, down; Q-Former
             packed in_proj, cross k/v, ffn.0, ffn.2) with M = 1, 7, 32, 128,
             plus a K % 64 tail with ragged N and K = 16, each also with f32
             output; per row, max-abs error <= 1e-2 of the row's largest
             value; kernel (per call, on the device alone from a CUDA-graph
             replay, and issued back to back), plain, library
             (`torch._weight_int8pack_mm` where it runs, else dequantize +
             matmul; by events and on the device), the bf16 weights'
             `F.linear` on the device and bound, per shape and summed per
             decoder pass;
8. K6      — quant_matmul_int4 against its plain version at every (K, N) of
             an int4 projection (decoder q/o, k/v, gate/up, down; group 128)
             with M = 1, 7, 32, 128, plus one group (K = 128) and a 256-wide
             group, each also with f32 x; the same check and readings as K5's
             (library: `torch._weight_int4pack_mm` where it runs, else
             dequantize + matmul), and its SASS must hold no I2F (nibbles
             convert by lop3);
8b. K9     — fused_mlp_matvec against its plain version at D = 4096,
             I = 14336, M = 1 and 8, both tilings (block_i 64 and 128),
             random int8 weights from the seed: max-abs error over max |plain|
             <= 1e-2, cosine >= 0.9999; kernel (events and device-only),
             plain, the K5 route (K5 gate and up, F.silu(g) * u, K5 down),
             `torch._weight_int8pack_mm` x 3 + F.silu where it runs, bound;
9. slice1  — full-width Zephyr-7B + CLIP-L/336 + Q-Former with random bf16
             weights, the port's /chat server on 127.0.0.1 with no flags, 3
             sessions and 4 requests; checks the launch counters and the
             kernel path's prefill and decode-step-8 logits against the plain
             path (cosine >= 0.999); TTFT and decode tokens/s;
10. paged  — the same model behind the server started with
             `--continuous-batching --kv-cache paged --kv-quant --max-slots 32`
             (KV-fused int8 pools, page 128, prefill chunk 256): 48 /chat
             requests from 48 sessions sent at once, prompts of about 40, 300
             and 600 words; every reply HTTP 200 with all its tokens; launch
             counters exact (K3 = 32 x decode steps, K4 = decode steps, K2 =
             32 x prefill chunks); slots reused; every page back in the
             allocator;
11. batch  — direct PagedBatchers with the same 16 requests admitted before
             the first step, whole (K1) and in chunks of 256 (K2 at T=256), on
             the kernel path and on the plain path, and with bf16 pools:
             chunked admission bit-equal between the paths; logits cosine per
             slot at steps 1 and 16 (kernel vs plain >= 0.999, int8 vs bf16
             pools >= 0.99); the two int8 runs' pools against each other
             (dequantized rows cosine >= 0.999, int8 values within 1 for
             >= 95 %, scales within 5 %);
11b. writefirst — the fixed batch of 16 (bf16 weights) stepped 16 times by
             `_paged_step(mode="writefirst")` and by mode "selfterm" on copies
             of its state, over bf16 split and int8 fused pools, both fed the
             selfterm step's tokens: logits cosine per slot >= 0.999 at every
             step, exactly 32 K3 and 32 paged_kv_update launches per
             writefirst step and no paged_kv_rows; greedy agreement printed;
             then one 32-slot step in each mode profiled side by side (wall,
             device busy, idle share, largest device items, K4's device time
             per launch);
12. spec   — speculation (`--lookahead 4`): two dense /chat requests with
             lookahead 4 and the same two with lookahead 0 (K1 and K2 counts
             exact, verify calls > 0; the streams' agreement printed); a
             paged server burst of 16 repetitive questions with `--lookahead
             4` (K3 = 32 x verify steps, paged_kv_update = 32 x verify
             steps, no paged_kv_rows launch), after the same burst without
             it for comparison; one verify step of a fixed
             batch of 16 on clones of int8 fused and bf16 split pools:
             kernel vs plain path cosine >= 0.999 on every column, column 0
             vs the decode step >= 0.99 (int8) and >= 0.999 (bf16); the
             verify steps of both paths replayed as CUDA graphs against the
             same steps run eagerly on the kernel path, 5 consecutive steps
             with acceptance and rollback between them, bit for bit (paged:
             32 slots, logits, pools, lengths, pending tokens and streams,
             K3 and K4 exact; dense: greedy tokens, logits, K, V and
             lengths, K2 and verify calls exact), then each form's wall,
             device busy and idle share and the graph pools (printed);
12b. multistep — multi-step bursts (`--multi-step 8`); every served decode
             step is a CUDA-graph replay, in bursts of one by default: a
             fixed batch of 32 slots (int8 fused pools) stepped 8 times by
             replays and 8 times by eager kernel-path `_paged_step`s on
             clones of its state (tokens equal on every slot at every step,
             logits cosine >= 0.999 per slot per step, K3 and K4 counted
             exactly, a replay as a launch); a burst of 8 on graphs against
             8 eager steps with the carry on the host, budgets 1 to 9 and an
             EOS inside the burst (tokens, alive masks, pools and lengths
             exactly equal); a burst of 8 against the same burst under
             `plain_versions()` (each slot's first differing step printed;
             last-step cosine >= 0.999 on the slots that never differ, at
             least 16 of them); the paged server burst of 48 requests with
             `--multi-step 8` (every reply HTTP 200 with all its tokens, K3 =
             32 x decode steps and K4 = decode steps with a burst's steps
             counted, bursts run, every page back); the B = 1 dense step
             replayed against the eager `decode_step`, 9 steps bit for bit;
             two dense /chat requests with `--multi-step 8` and the same two
             with `--multi-step 1` (K1 and K2 exact, streams equal); then,
             printed and not gated, the wall, device busy and idle share per
             token of the 32-slot step and of the B = 1 dense step run
             eagerly and in bursts of 1, 4, 8 and 16, the captures' host
             time and graph pools' memory, and a burst of 8 on int8 and on
             int4 weights in phases 15 and 16;
13. profile — only with --profile: wall, device-busy and idle share of one
             batched decode step at B=32, of one verify step (S = 5) and of
             one dense decode step (B = 1), their kernel launches per step
             and the largest device items (torch.profiler); a text-only prefill
             of 2048 tokens (K1's share of its device time, one K1 launch a
             layer); the decode step again on int8 and int4 weights after
             phases 15 and 16, the verify step on int8 weights;
14. precision — (it widens the model in place): the bf16 prefill logits
             against an f32 run of the same weights (the JAX engine's
             arithmetic for f32 pixels; cosine >= 0.999);
15. int8   — the model rebuilt from the same seed and quantized in place by
             `load_8bit`'s step (`models/builder.py::quantize_weights`;
             memory before, after and at the peak), then 2 dense /chat
             requests and a paged burst of 16 on it, and the fixed batch of
             16 admitted whole on the kernel path, the plain path and against
             phase 11's bf16 logits (fed its tokens): kernel vs plain cosine
             >= 0.999, int8 vs bf16 weights >= 0.997; K5 (224 per decoder
             launch a chunk of at most 128 rows, up to `QMM_CHUNK_MAX_M`
             rows a pass) and dequantize-route counts (224 per longer pass)
             exact against what the prefill, chunk and step counters
             predict, the Q-Former's projections counted by rows; 14 verify
             steps of 32 slots (160 rows: K5 on chunks of 128 and 32 rows,
             no dequantize call) counted, the replayed step's wall, device
             busy and idle share printed;
15b. mlp_probe — `python -m vis_zephyr_tpu_torch.experiments.fused_mlp_matvec_probe`'s
             `main()` (numerics, then 32 chained calls in one CUDA graph for K9
             at each tiling and for the K5 route: us per layer, weight GB/s,
             speedup), and K9 on layer 0's MLP of phase 15's int8 model (a
             full-width MLP quantized alike when phase 15 does not run) at M = 1
             against `layer.mlp(hn)`: cosine >= 0.999;
16. int4   — the same on a model rebuilt from the seed and quantized by
             `load_4bit`'s step (int4 decoder with group-128 scales, int8
             Q-Former): 2 dense requests, a paged burst of 16, the fixed batch
             (kernel vs plain cosine >= 0.999; against bf16 and int8 weights
             printed, not gated: random weights say nothing of int4's
             quality); K6 (224 per decoder pass, a launch a chunk of at most
             128 rows), its dequantize route (224 per pass past
             `QMM_CHUNK_MAX_M` rows) and K5 (the Q-Former's rows) counted
             exactly; the 160-row verify steps as on int8 weights (K6 on
             chunks, no dequantize call);
17. train  — the served model freed, stage 1 through the trainer's entry
             point `train/train.py::train` at full width with random bf16
             weights from the seed: 3 steps of 8 `<image>` captions (4 anyres
             crops each, seeded pixels through the `dataset` seam, captions
             long enough that `model_max_length` 2048 truncates the splice),
             remat on; loss, grad_norm, step time and tokens/s per step, peak
             memory, the final saves' seconds and bytes (into a temporary
             directory, removed); one more step under torch.profiler for the
             device's idle share; one stage-1 step of 2 rows on the kernel
             path and on the plain path (loss within 1e-3 relative, projector
             gradient cosine >= 0.999); stage 2 (LoRA r=128, alpha=256,
             dropout 0.05) through `make_train_step` for 2 steps; K1 = 64,
             K7 = K8 = 32 launches per micro-step, exactly;
18. attn_probes — last, after every served phase: K10 and K11 must not
             have launched yet. The two attention probes' `main()`
             (`vis_zephyr_tpu_torch/experiments/batched_paged_attention_probe.py`
             and `paired_slot_attention_probe.py`: numerics against the plain
             version and K3, gated at 1e-2 per slot and cosine 0.9999, K11
             at two splits and its first design too; then K3, K10 at
             pages_per_block 1, 5, 8, K11 and its first design
             (`vzt_paged_attn_paired_walk`) at P = 2, 4, 8 in CUDA graphs of
             32 layer calls at 128 slots of 640 tokens and at 32 slots of
             60-800, each route's layer-0 output at both shapes gated
             against the plain version the same way), their launches
             counted from 0; K11's SASS (HMMA, UTMALDG, UBLKCP required)
             and registers; then K10 and K11 at B=32 (lengths 0 to 2048,
             int8 fused pools, self-term) against their plain version and K3
             per slot (<= 1e-2, cosine >= 0.9999) at P = 1, 2, 4, 8,
             pages_per_block 1, 5, 6, 8, with and without a window of 512;
             the slot of length 0 exactly its v_new; NaN scales past length
             bit for bit harmless; `paged_attention_fa(slot_block=2)` routed
             to K11 on fused int8 pools and to K3 on split bf16 ones,
             counted; times at the bench shape for the result line, each
             timed call's output gated against the plain version.

`--phases` runs a subset (kernels, slice1, paged, batch, writefirst, spec,
multistep, profile, precision, int8, mlp_probe, int4, train, attn_probes) and then
prints no result line. After a full run the line before
last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}. Any failed check raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import http.client
import json
import math
import os
import re
import statistics
import subprocess
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch

# Published peaks of one H100 SXM at its full 700 W: HBM bytes/s, dense bf16
# tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # outside the tensor cores


def bound_ms(n_bytes: float, n_flops: float, peak: float = BF16_FLOPS):
    """The least time the card could take: (ms, "bytes" | "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


def median_ms(fn, runs: int = 20) -> float:
    """Median of `runs` CUDA-event timings of fn() after two warm-up calls."""
    fn()
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, runs: int = 10):
    """Device time of one fn() without the host's launch path: `calls` calls
    captured in a CUDA graph, the graph replayed `runs` times, the median
    CUDA-event time of a replay over `calls`. None (printed as not measured)
    when fn cannot be captured."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
    except RuntimeError as e:
        print(f"graph capture failed ({str(e).splitlines()[0][:120]}): device time not measured")
        torch.cuda.synchronize()
        return None
    ms = median_ms(graph.replay, runs) / calls
    del graph
    return ms


def show(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def issue_ms(fn, calls: int = 50) -> float:
    """Host time to issue one fn() when calls go back to back: the wall of
    `calls` calls ended by a synchronize, over `calls`. Above the device time
    it is the wrapper's host path."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def masked_lse(q, k, kv_valid, causal, scale):
    """f32 per-row logsumexp [B, Hq, T] of the masked scores (the kernel's
    m + log l); -inf on rows without a valid key."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, T, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    mask = kv_valid[:, None, None, None, :].clone()
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(S, device=q.device)[None, :]
        mask = mask & (cols <= rows)
    s = s.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, T)


@functools.lru_cache(maxsize=None)
def _cuobjdump(flag: str) -> str:
    """`cuobjdump <flag>` of the built kernel library (nvcc's own tool)."""
    from vis_zephyr_tpu_torch.ops import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    dump = subprocess.run([tool, flag, _kernels.LIB], capture_output=True, text=True,
                          timeout=300)
    if dump.returncode != 0:
        raise AssertionError(f"cuobjdump {flag} failed ({dump.returncode}): {dump.stderr[-500:]}")
    return dump.stdout


def sass_counts(function: str, ops=("HGMMA", "UTMALDG", "UTMASTG")) -> dict:
    """Instructions of each kind in `ops` (by default HGMMA (wgmma), UTMALDG
    (TMA load) and UTMASTG (TMA store)) in the built library's functions whose
    names hold `function` (summed over a template's instantiations), read
    with `cuobjdump -sass`."""
    sections = re.split(r"\n\s*Function : ", _cuobjdump("-sass"))[1:]
    body = "".join(sec for sec in sections if function in sec.split("\n", 1)[0])
    if not body:
        raise AssertionError(f"cuobjdump -sass shows no {function} function")
    return {op: len(re.findall(rf"\b{op}\b", body)) for op in ops}


def resource_usage(function: str) -> dict:
    """Registers at entry, stack-frame bytes (where ptxas puts spills) and
    local-memory bytes of the functions whose names hold `function` (the
    largest over a template's instantiations), from `cuobjdump -res-usage`;
    None where the dump does not say."""
    lines = _cuobjdump("-res-usage").splitlines()
    usage = {"reg": None, "local": None, "stack": None}
    for i, line in enumerate(lines):
        if "Function" in line and function in line:
            text = " ".join(lines[i:i + 2])
            for key in usage:
                m = re.search(rf"\b{key.upper()}:(\d+)", text)
                if m:
                    usage[key] = max(usage[key] or 0, int(m.group(1)))
    return usage


def flash_pairs(kv_valid, T: int, causal: bool) -> int:
    """The (row, key) pairs attention needs on these inputs: valid keys, and
    col <= row under `causal` (each costs 4 * Hq * D FLOPs for the two products)."""
    S = kv_valid.shape[1]
    if not causal:
        return int(kv_valid.sum()) * T
    seen = kv_valid.long().cumsum(dim=1)          # valid keys at or before each column
    rows = torch.arange(T, device=kv_valid.device).clamp(max=S - 1)
    return int(seen[:, rows].sum())


def check_flash(gen) -> dict:
    """K1 against its plain version run in f32 on the same bf16 inputs, one
    batch row at a time: output max-abs <= 2e-2 and logsumexp (m + log l)
    max-abs <= 1e-2 on rows with a key; on a row without one the output is
    exactly 0, l = 0 and m = NEG_INF. The first four cases are the phase's
    oldest (their inputs come first from `gen`); the rest (the trainer's B=8, T=2048 with
    right-padded keys, a 64-row half tile, S != T with S not a multiple of
    128, GQA group 1) draw from a generator of their own, so later phases see
    the inputs they saw before. Timed, B=1 at T=S 256 and 2048 and the
    trainer's shape: kernel (CUDA events around one call, and on the device
    alone from a CUDA-graph replay), plain, `scaled_dot_product_attention`
    (with the padding as a boolean mask where there is one; the same two
    readings) and the bound from this run's valid pairs. Fails if K1's SASS
    has no HGMMA or no UTMALDG."""
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    D = 128
    sass = sass_counts("flash_fwd_kernel")
    print(f"K1 SASS (cuobjdump -sass, flash_fwd_kernel): {sass}")
    if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
        raise AssertionError(f"K1 does not run on wgmma fed by TMA: {sass}")
    S_row = torch.arange(256, device=dev)
    padded = torch.stack([S_row < 200, (S_row >= 1) & (S_row < 230)])  # b=1, q row 0: no key
    rows_2048 = torch.arange(2048, device=dev)
    lengths = torch.tensor([2048, 1900, 1664, 1537, 1280, 1029, 700, 333], device=dev)
    ragged = rows_2048[None, :] < lengths[:, None]   # each row's keys right-padded
    extra = torch.Generator(dev).manual_seed(gen.initial_seed() + 1)
    cases = [
        # name, B, T, S, Hq, Hkv, causal, kv_valid, generator, timed as
        ("causal T=S=256", 1, 256, 256, 32, 8, True, None, gen, 256),
        ("causal T=S=2048", 1, 2048, 2048, 32, 8, True, None, gen, 2048),
        ("non-causal T=256 S=512", 1, 256, 512, 32, 8, False, None, gen, None),
        ("causal B=2 padded kv_valid", 2, 256, 256, 32, 8, True, padded, gen, None),
        ("causal B=8 T=S=2048 right-padded keys", 8, 2048, 2048, 32, 8, True, ragged, extra,
         "B8_2048"),
        ("causal T=S=192 (a 64-row half tile)", 1, 192, 192, 32, 8, True, None, extra, None),
        ("non-causal T=128 S=320", 1, 128, 320, 32, 8, False, None, extra, None),
        ("causal T=S=256 GQA group 1 (Hq=Hkv=8)", 1, 256, 256, 8, 8, True, None, extra, None),
    ]
    worst = 0.0
    times = {}
    for name, B, T, S, Hq, Hkv, causal, kv_valid, g, timed in cases:
        q = torch.randn(B, T, Hq, D, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        if kv_valid is None:
            kv_valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        scale = D ** -0.5
        out, m, l = fa.flash_attention_fwd(q, k, v, kv_valid, causal, scale)
        torch.cuda.synchronize()
        out_err = lse_err = 0.0
        n_empty = 0
        for b in range(B):  # the f32 reference one batch row at a time
            row = slice(b, b + 1)
            ref = fa.flash_attention_plain(q[row].float(), k[row].float(), v[row].float(),
                                           kv_valid[row], causal, scale)
            ref_lse = masked_lse(q[row], k[row], kv_valid[row], causal, scale)
            has_key = torch.isfinite(ref_lse)
            err = (out[row].float() - ref).abs()
            # Rows without a valid key must be exactly 0 (the plain version's
            # uniform softmax over -1e30 scores is no reference there).
            err = err.masked_fill(~has_key.transpose(1, 2)[..., None], 0.0)
            out_err = max(out_err, float(err.max()))
            empty_rows = ~has_key.transpose(1, 2)
            if bool(empty_rows.any()):
                n_empty += int(empty_rows.sum())
                if float(out[row].float()[empty_rows].abs().max()) != 0.0:
                    raise AssertionError(f"K1 {name}: a row with no valid key is not 0")
                if bool((l[row][~has_key] != 0).any()):
                    raise AssertionError(f"K1 {name}: l is not 0 on a row with no valid key")
                if bool((m[row][~has_key] != fa.NEG_INF).any()):
                    raise AssertionError(f"K1 {name}: m is not NEG_INF on a row with no valid key")
            lse = m[row] + torch.log(l[row])
            lse_err = max(lse_err, float((lse - ref_lse)[has_key].abs().max()))
            del ref, ref_lse, err
        print(f"K1 {name}: out max-abs {out_err:.3e} (<= 2e-2), lse max-abs "
              f"{lse_err:.3e} (<= 1e-2), rows without a key: {n_empty}")
        if not (out_err <= 2e-2 and lse_err <= 1e-2):
            raise AssertionError(f"K1 {name}: kernel disagrees with the plain version")
        worst = max(worst, out_err)
        if timed is not None:
            def kernel():
                fa.flash_attention_fwd(q, k, v, kv_valid, causal, scale)

            kernel_ms = median_ms(kernel)
            device_ms = graph_ms(kernel)   # without the wrapper's host path
            plain_ms = median_ms(lambda: fa.flash_attention_plain(q, k, v, kv_valid, causal, scale))
            # The yardstick: one library call for the same function (never on a
            # served path); padded keys go in as a boolean mask with the causal rule.
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if bool(kv_valid.all()):
                def library():
                    torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
            else:
                keep = (kv_valid[:, None, None, :]
                        & (torch.arange(S, device=dev)[None, :]
                           <= torch.arange(T, device=dev)[:, None])[None, None])

                def library():
                    torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=keep, scale=scale, enable_gqa=True)
            try:
                library_ms = median_ms(library)
                library_device_ms = graph_ms(library)
            except RuntimeError as e:  # no backend takes this mask with GQA
                print(f"K1 {name}: scaled_dot_product_attention failed "
                      f"({str(e).splitlines()[0][:120]}): library time not measured")
                library_ms = library_device_ms = None
            # q, k, v and out once, kv_valid, m and l; 4·Hq·D FLOPs per valid pair.
            n_bytes = (2 * (2 * q.numel() + k.numel() + v.numel()) + kv_valid.numel()
                       + 2 * 4 * B * Hq * T)
            least, by = bound_ms(n_bytes, 4 * Hq * D * flash_pairs(kv_valid, T, causal))
            times[timed] = dict(ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms,
                                library_ms=library_ms, library_device_ms=library_device_ms,
                                bound_ms=least, bound_by=by)
            print(f"K1 {name}: kernel {kernel_ms:.4f} ms per call, {show(device_ms)} on the "
                  f"device; plain (bf16 matmul + f32 softmax) {plain_ms:.4f} ms; "
                  f"scaled_dot_product_attention {show(library_ms)} ms per call, "
                  f"{show(library_device_ms)} on the device; bound {least:.5f} ms by {by}; "
                  f"median of 20")
        del q, k, v, out, m, l
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "times": times, "sass": sass}


def check_flash_bwd(gen) -> dict:
    """K7 (dK, dV) and K8 (dQ) against `flash_attention_bwd_plain` run in f32
    on the same bf16 inputs and K1's m and l, one batch row at a time, in
    K1's first four cases, at the trainer's B=8, T=S=2048 with each row's
    keys right-padded to another length, at B=16, T=S=320 (K7's 128-key
    blocks with a 64-key last tile) and non-causal T=128 S=320 (the last
    three draw from a generator of their own, so later phases see the
    inputs they saw before). Gate per tensor: max-abs error <= 1e-2 of the
    tensor's largest |value| and cosine >= 0.9999; q rows with no valid key
    give dQ = 0 and invalid keys dK = dV = 0, exactly. Fails unless both
    kernels' SASS holds HGMMA and UTMALDG.
    Timed at causal B=1, T=S 256 and 2048 and at the B=8 shape: each kernel
    (CUDA events around one call, and on the device alone from a CUDA-graph
    replay), its plain version, the bound from this run's valid pairs, and
    the backward of `scaled_dot_product_attention` (the padding as a boolean
    mask at B=8; the same two readings)."""
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    dev = "cuda"
    Hq, Hkv, D = 32, 8, 128
    out = {"dkv": {"max_abs_err": 0.0, "times": {}}, "dq": {"max_abs_err": 0.0, "times": {}}}
    for kernel, function in (("dkv", "flash_bwd_dkv_kernel"), ("dq", "flash_bwd_dq_kernel")):
        sass, res = sass_counts(function), resource_usage(function)
        print(f"K7/K8 SASS (cuobjdump -sass, {function}): {sass}; cuobjdump -res-usage: "
              f"{res['reg']} registers at entry, a stack frame of {res['stack']} bytes (spills "
              f"land there), {res['local']} bytes of local memory")
        if not (sass["HGMMA"] > 0 and sass["UTMALDG"] > 0):
            raise AssertionError(f"{function} does not run on wgmma fed by TMA: {sass}")
        out[kernel].update(sass=sass, resources=res)
    S_row = torch.arange(256, device=dev)
    padded = torch.stack([S_row < 200, (S_row >= 1) & (S_row < 230)])  # b=1, q row 0: no key
    lengths = torch.tensor([2048, 1900, 1664, 1537, 1280, 1029, 700, 333], device=dev)
    ragged = torch.arange(2048, device=dev)[None, :] < lengths[:, None]
    extra = torch.Generator(dev).manual_seed(gen.initial_seed() + 2)
    cases = [
        # name, B, T, S, causal, kv_valid, generator, timed as
        ("causal T=S=256", 1, 256, 256, True, None, gen, 256),
        ("causal T=S=2048", 1, 2048, 2048, True, None, gen, 2048),
        ("non-causal T=256 S=512", 1, 256, 512, False, None, gen, None),
        ("causal B=2 padded kv_valid", 2, 256, 256, True, padded, gen, None),
        ("causal B=8 T=S=2048 right-padded keys", 8, 2048, 2048, True, ragged, extra, "B8_2048"),
        # K7 on 128-key blocks (a grid as large as the card) with a 64-key
        # last tile, and on split 64-key blocks with S != T.
        ("causal B=16 T=S=320", 16, 320, 320, True, None, extra, None),
        ("non-causal T=128 S=320", 1, 128, 320, False, None, extra, None),
    ]
    for name, B, T, S, causal, kv_valid, g, timed in cases:
        q = torch.randn(B, T, Hq, D, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(torch.bfloat16)
        do = torch.randn(B, T, Hq, D, generator=g, device=dev).to(torch.bfloat16)
        if kv_valid is None:
            kv_valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        scale = D ** -0.5
        o, m, l = fa.flash_attention_fwd(q, k, v, kv_valid, causal, scale)
        di = fa.row_dot(o, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, kv_valid, do, m, l, di, causal, scale)
        dq = fa.flash_attention_bwd_dq(q, k, v, kv_valid, do, m, l, di, causal, scale)
        torch.cuda.synchronize()
        rows = [fa.flash_attention_bwd_plain(q[b:b + 1].float(), k[b:b + 1].float(),
                                             v[b:b + 1].float(), kv_valid[b:b + 1],
                                             o[b:b + 1].float(), m[b:b + 1], l[b:b + 1],
                                             do[b:b + 1].float(), causal, scale)
                for b in range(B)]
        ref = [torch.cat(parts) for parts in zip(*rows)]
        del rows
        parts = []
        for tname, kernel, got, want in (("dQ", "dq", dq, ref[0]), ("dK", "dkv", dk, ref[1]),
                                         ("dV", "dkv", dv, ref[2])):
            err = float((got.float() - want).abs().max())
            top = float(want.abs().max())
            cos = cosine(got, want)
            parts.append(f"{tname} max-abs {err:.3e} (<= {1e-2 * top:.3e}) cosine {cos:.6f}")
            if not (err <= 1e-2 * top and cos >= 0.9999):
                raise AssertionError(f"K7/K8 {name}: {tname} disagrees with the plain version "
                                     f"(max-abs {err:.3e} of {top:.3e}, cosine {cos:.6f})")
            out[kernel]["max_abs_err"] = max(out[kernel]["max_abs_err"], err)
        del ref
        empty = ~fa._mask(kv_valid, T, S, causal)[:, 0].any(dim=-1)          # [B, T]
        if bool(empty.any()) and float(dq[empty].abs().max()) != 0.0:
            raise AssertionError(f"K8 {name}: dQ is not 0 on a row with no valid key")
        if bool((~kv_valid).any()) and (float(dk[~kv_valid].abs().max()) != 0.0
                                        or float(dv[~kv_valid].abs().max()) != 0.0):
            raise AssertionError(f"K7 {name}: dK or dV is not 0 on an invalid key")
        print(f"K7/K8 {name}: {'; '.join(parts)}; rows without a key: {int(empty.sum())}, "
              f"invalid keys: {int((~kv_valid).sum())}")
        if timed is not None:
            args = (q, k, v, kv_valid, do, m, l, di, causal, scale)
            readings = {}
            for kernel, launch, plain in (
                    ("dkv", fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dkv_plain),
                    ("dq", fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dq_plain)):
                readings[kernel] = dict(ms=median_ms(lambda: launch(*args)),
                                        device_ms=graph_ms(lambda: launch(*args)),
                                        plain_ms=median_ms(lambda: plain(*args)))
            # The yardstick (never on the port's path): the library's fused
            # attention backward alone, its forward taken once outside the
            # timing; padded keys go in as a boolean mask with the causal rule.
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            if bool(kv_valid.all()):
                sdpa = dict(is_causal=True)
            else:
                sdpa = dict(attn_mask=kv_valid[:, None, None, :]
                            & (torch.arange(S, device=dev)[None, :]
                               <= torch.arange(T, device=dev)[:, None])[None, None])
            try:
                o_lib = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale, enable_gqa=True, **sdpa)
                g_lib = do.transpose(1, 2)

                def library():
                    torch.autograd.grad(o_lib, (qt, kt, vt), g_lib, retain_graph=True)

                library_ms = median_ms(library)
                library_device_ms = graph_ms(library)
                del o_lib
            except RuntimeError as e:  # no backend takes this mask with GQA
                print(f"K7/K8 {name}: scaled_dot_product_attention backward failed "
                      f"({str(e).splitlines()[0][:120]}): library time not measured")
                library_ms = library_device_ms = None
            # Each product is 2·Hq·D FLOPs per valid (row, key) pair: K7 does
            # four (S, dP, dV, dK), K8 three (S, dP, dQ). Bytes: every input
            # read once, every output written once.
            pair_flops = 2 * Hq * D * flash_pairs(kv_valid, T, causal)
            rows_bytes = 4 * 3 * B * Hq * T + kv_valid.numel()  # m, l, di in f32
            bounds = {"dkv": bound_ms(2 * (q.numel() + do.numel() + 2 * k.numel() + 2 * v.numel())
                                      + rows_bytes, 4 * pair_flops),
                      "dq": bound_ms(2 * (2 * q.numel() + do.numel() + k.numel() + v.numel())
                                     + rows_bytes, 3 * pair_flops)}
            for kernel, (least, by) in bounds.items():
                out[kernel]["times"][timed] = dict(
                    **readings[kernel], library_ms=library_ms,
                    library_device_ms=library_device_ms, bound_ms=least, bound_by=by)
            r7, r8 = readings["dkv"], readings["dq"]
            print(f"K7/K8 {name}: K7 {r7['ms']:.4f} ms per call, {show(r7['device_ms'])} on the "
                  f"device, plain {r7['plain_ms']:.4f} ms, bound {bounds['dkv'][0]:.5f} ms by "
                  f"{bounds['dkv'][1]}; K8 {r8['ms']:.4f} ms per call, {show(r8['device_ms'])} on "
                  f"the device, plain {r8['plain_ms']:.4f} ms, bound {bounds['dq'][0]:.5f} ms by "
                  f"{bounds['dq'][1]}; scaled_dot_product_attention backward (dQ, dK, dV "
                  f"together) {show(library_ms)} ms per call, {show(library_device_ms)} on the "
                  f"device; median of 20")
            del qt, kt, vt
        del q, k, v, do, o, m, l, di, dq, dk, dv
        torch.cuda.empty_cache()
    return out


def check_cache_append(gen) -> dict:
    """K2's two entries against their plain versions, bit for bit:
    `dense_cache_update` (rows already rotated, the JAX contract) and
    `dense_cache_update_rope` (K before RoPE, rotated in the kernel: what
    the dense-cache forward calls once a layer), at the dense decode step's
    shape, a clamped tail and chunked admission's T = 256 chunks. Timed at
    the decode shape (and the rope entry at a chunk): per call, on the
    device (graph replay), issued back to back; beside it the route the
    forward took before, eager `apply_rope` then the copy entry."""
    from vis_zephyr_tpu_torch.config import DecoderConfig
    from vis_zephyr_tpu_torch.models.mistral import rope_cos_sin
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import kv_cache

    dev = "cuda"
    dec = DecoderConfig()
    Hkv, D = dec.num_kv_heads, dec.head_dim
    # The dense decode step's shape, a clamped tail, and chunked admission's
    # shapes (one 256-token chunk into a B=1 scratch cache): the third chunk of
    # a longer prompt, and a last chunk that ends exactly at the cache's end.
    cases = [("L=32 B=1 S=2048 T=1", 32, 1, 2048, 1, [517]),
             ("L=32 B=3 S=2048 T=4, one length at S-2", 32, 3, 2048, 4, [0, 1000, 2046]),
             ("L=32 B=1 S=1024 T=256 at 512 (a prefill chunk)", 32, 1, 1024, 256, [512]),
             ("L=32 B=1 S=768 T=256 at 512 (the chunk that fills the cache)", 32, 1, 768, 256,
              [512]),
             ("L=32 B=1 S=768 T=256 at 640 (128 rows clamped to S-1)", 32, 1, 768, 256, [640])]
    times = None
    for name, L, B, S, T, lens in cases:
        ck = torch.randn(L, B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        cv = torch.randn(L, B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        positions = lengths[:, None] + torch.arange(T, dtype=torch.int32, device=dev)[None, :]
        cos, sin = rope_cos_sin(positions, D, dec.rope_theta)
        layer = L - 3
        for entry in ("copy", "rope"):
            got_k, got_v = ck.clone(), cv.clone()
            ref_k, ref_v = ck.clone(), cv.clone()
            if entry == "copy":
                kv_cache.dense_cache_update(got_k, got_v, k, v, lengths, layer)
                kv_cache.dense_cache_update_plain(ref_k, ref_v, k, v, lengths, layer)
            else:
                kv_cache.dense_cache_update_rope(got_k, got_v, k, v, cos, sin, lengths, layer)
                kv_cache.dense_cache_update_rope_plain(ref_k, ref_v, k, v, cos, sin, lengths,
                                                       layer)
            torch.cuda.synchronize()
            exact = torch.equal(got_k, ref_k) and torch.equal(got_v, ref_v)
            changed = int((got_k[layer] != ck[layer]).any(dim=-1).any(dim=-1).sum())
            print(f"K2 {entry} entry, {name}: bit-exact against the plain version: {exact} "
                  f"({changed} cache rows changed)")
            if not exact or changed == 0:
                raise AssertionError(f"K2 {entry} entry, {name}: kernel disagrees with the "
                                     "plain version")
        if (T, lens) not in ((1, [517]), (256, [512])) or S == 768:
            continue
        # The rows read once and written once (and the rope entry's cos / sin
        # tables read once); its arithmetic is a few operations an element.
        n_rows = B * T
        copy_bound = bound_ms(2 * 2 * (k.numel() + v.numel()), 0)
        rope_bound = bound_ms(2 * 2 * (k.numel() + v.numel()) + 2 * 4 * n_rows * D // 2,
                              6 * k.numel(), FP32_FLOPS)

        def copy_call():
            kv_cache.dense_cache_update(got_k, got_v, k, v, lengths, layer)

        def rope_call():
            kv_cache.dense_cache_update_rope(got_k, got_v, k, v, cos, sin, lengths, layer)

        def before_call():  # the dense-cache forward's route before the rope entry
            kv_cache.dense_cache_update(got_k, got_v, kv_cache.apply_rope(k, cos, sin), v,
                                        lengths, layer)

        rows = torch.arange(B, device=dev)[:, None]
        slots = torch.clamp(positions.long(), max=S - 1)
        k_rot = kv_cache.apply_rope(k, cos, sin)

        def library_call():  # the write half only: the rotated rows by index_put_
            ref_k[layer].index_put_((rows, slots), k_rot)
            ref_v[layer].index_put_((rows, slots), v)

        row = {}
        for label, fn in (("rope", rope_call), ("copy", copy_call), ("before", before_call),
                          ("library", library_call)):
            row[label] = dict(ms=median_ms(fn), device_ms=graph_ms(fn), issue_ms=issue_ms(fn))
        with _kernels.plain_versions():
            plain_ms = median_ms(rope_call)
            copy_plain_ms = median_ms(copy_call)
        print(f"K2 rope entry, {name}: kernel {row['rope']['ms']:.4f} ms per call, "
              f"{show(row['rope']['device_ms'])} on the device, issued back to back "
              f"{row['rope']['issue_ms']:.4f}; plain (apply_rope, casts, {T} indexed writes) "
              f"{plain_ms:.4f} ms; bound {rope_bound[0]:.6f} ms by {rope_bound[1]}; before "
              f"(eager apply_rope + the copy entry) {row['before']['ms']:.4f} per call, "
              f"{show(row['before']['device_ms'])} on the device, issued "
              f"{row['before']['issue_ms']:.4f}; index_put_ of the rotated rows "
              f"{row['library']['ms']:.4f}, {show(row['library']['device_ms'])} on the device; "
              f"median of 20")
        print(f"K2 copy entry, {name}: kernel {row['copy']['ms']:.4f} ms per call, "
              f"{show(row['copy']['device_ms'])} on the device, issued "
              f"{row['copy']['issue_ms']:.4f}; plain ({T} indexed writes) {copy_plain_ms:.4f} "
              f"ms; bound {copy_bound[0]:.6f} ms by {copy_bound[1]}")
        if times is None:  # the decode step's shape goes into the result line
            times = dict(ms=row["rope"]["ms"], device_ms=row["rope"]["device_ms"],
                         issue_ms=row["rope"]["issue_ms"], plain_ms=plain_ms,
                         library_ms=row["library"]["ms"],
                         library_device_ms=row["library"]["device_ms"],
                         bound_ms=rope_bound[0], bound_by=rope_bound[1],
                         before=row["before"], copy_entry=dict(row["copy"], plain_ms=copy_plain_ms,
                                                                bound_ms=copy_bound[0]))
        else:
            times["chunk_256"] = dict(row["rope"], plain_ms=plain_ms, bound_ms=rope_bound[0],
                                      before=row["before"])
    return {"max_abs_err": 0.0, "times": times}


def paged_case(gen, lengths, quant: bool, fused: bool, layers: int = 2):
    """Pools of `layers` layers in the port's layout with a shuffled page table
    [B, 16]: every slot owns 16 pages of its own; page 0 is the trash page."""
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    Hkv, D, ps, pps = 8, 128, 128, 16
    B = len(lengths)
    P = B * pps + 1
    table = (torch.randperm(P - 1, generator=gen, device=dev)[:B * pps] + 1).reshape(B, pps)
    shape = (layers * P, Hkv, ps, D)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    ksc = vsc = None
    if quant:
        kp, ksc = pa.quantize_kv_pool(kp)
        vp, vsc = pa.quantize_kv_pool(vp)
    if fused:
        kp, vp = torch.cat([kp, vp], dim=2), None
        if quant:
            ksc, vsc = torch.cat([ksc, vsc], dim=2), None
    return dict(kp=kp, vp=vp, ksc=ksc, vsc=vsc, table=table.to(torch.int32).contiguous(),
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev), P=P)


def paged_call(pa, case, q, selfterm, k_new, v_new, window=None, plain=False, **over):
    from vis_zephyr_tpu_torch.ops import _kernels

    if plain:
        with _kernels.plain_versions():
            return paged_call(pa, case, q, selfterm, k_new, v_new, window, **over)
    S = q.shape[1]
    lengths = case["lengths"]
    q_offs = lengths if selfterm else (lengths - S).contiguous()
    c = dict(case, **over)
    return pa.paged_attention_fa(
        q, c["kp"], c["vp"], c["table"], lengths, q_offs, sliding_window=window,
        k_scales=c["ksc"], v_scales=c["vsc"], k_new=k_new if selfterm else None,
        v_new=v_new if selfterm else None, page_offset=case["P"])


# K3's SASS: tensor-core products (HMMA: mma.sync), the pages by TMA
# (UTMALDG) and the scales by bulk copy (UBLKCP).
K3_SASS_OPS = ("HMMA", "UTMALDG", "UBLKCP")


def check_paged_attention(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    sass = sass_counts("paged_attn_decode", K3_SASS_OPS)
    resources = resource_usage("paged_attn_decode")
    print(f"K3 SASS (paged_attn_decode, every instantiation): {sass}; registers and stack "
          f"(spills) of the largest: {resources}")
    if not all(sass[op] for op in K3_SASS_OPS):
        raise AssertionError(f"K3's SASS lacks tensor-core or bulk-copy instructions: {sass}")
    dev = "cuda"
    Hq, Hkv, D, ps, B = 32, 8, 128, 128, 32
    edge = [0, 1, 128, 129, 2048, 2047, 127, 1025]
    rand = torch.randint(1, 2049, (B - len(edge),), generator=gen, device=dev).tolist()
    lengths = edge + rand
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    worst = 0.0

    def slot_err(a, b):  # max-abs difference per slot, [B]
        return (a.float() - b.float()).abs().flatten(1).amax(dim=1)

    def compare(name, case, qq, selfterm, window=None, new=None):
        # A slot of 2048 keys has outputs near 0.05 and a slot of one key near
        # 3, so one max-abs over all slots would gate the long slots at half a
        # typical value. Each slot is held to its own scale instead: max-abs
        # error over the slot's largest |plain| value (a bf16 ulp is at most
        # 0.78 % of a value).
        nonlocal worst
        kn, vn = new or (k_new, v_new)
        got = paged_call(pa, case, qq, selfterm, kn, vn, window)
        torch.cuda.synchronize()
        want = paged_call(pa, case, qq, selfterm, kn, vn, window, plain=True)
        err = slot_err(got, want)
        top = want.float().abs().flatten(1).amax(dim=1)
        rel = torch.where(top > 0, err / top.clamp_min(1e-30), err)
        long_slots = case["lengths"] >= 1000
        long_rel = f"{float(rel[long_slots].max()):.3e}" if bool(long_slots.any()) else "none"
        print(f"K3 {name}: out max-abs {float(err.max()):.3e}; per slot, relative to the slot's "
              f"largest value: max {float(rel.max()):.3e} (<= 1e-2), over slots of >= 1000 keys "
              f"{long_rel}")
        if not (float(rel.max()) <= 1e-2 and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"K3 {name}: kernel disagrees with the plain version")
        worst = max(worst, float(err.max()))
        return got

    for quant, fused, label in ((False, False, "bf16 split"), (True, False, "int8 split"),
                                (True, True, "int8 fused")):
        case = paged_case(gen, lengths, quant, fused)
        for selfterm in (False, True):
            got = compare(f"{label}, {'self-term' if selfterm else 'pool only'}", case, q, selfterm)
            if not selfterm and float(got[0].float().abs().max()) != 0.0:
                raise AssertionError(f"K3 {label}: the slot with no key is not exactly 0")
        if not quant:
            # Whatever a recycled page holds at or past `length` must not reach
            # the output: NaN there, the same result bit for bit.
            clean = paged_call(pa, case, q, True, k_new, v_new)
            kd, vd = case["kp"].clone(), case["vp"].clone()
            for b, n in enumerate(lengths):
                if n < 2048:
                    page = int(case["table"][b, n // ps]) + case["P"]
                    kd[page, :, n % ps:] = float("nan")
                    vd[page, :, n % ps:] = float("nan")
            dirty = paged_call(pa, case, q, True, k_new, v_new, kp=kd, vp=vd)
            torch.cuda.synchronize()
            same = torch.equal(clean, dirty)
            print(f"K3 {label}: NaN rows past length leave the output unchanged: {same}")
            if not same:
                raise AssertionError("K3: rows past length reached the output")
    got = compare("int8 fused, self-term, window 512", case, q, True, window=512)
    # The window's edge: on the slots it cuts (query at `length`: 512 keys or more
    # in the pool), the kernel at 512 must sit nearer the plain
    # version at 512 than the plain version at 511 or 513, and differ from its
    # own unwindowed output.
    cut = case["lengths"] >= 512
    near = float(slot_err(got, paged_call(pa, case, q, True, k_new, v_new, 512, plain=True))[cut].sum())
    off = [float(slot_err(got, paged_call(pa, case, q, True, k_new, v_new, w, plain=True))[cut].sum())
           for w in (511, 513)]
    unwindowed = paged_call(pa, case, q, True, k_new, v_new)
    differs = bool((slot_err(got, unwindowed)[cut] > 0).all())
    same_short = torch.equal(got[~cut], unwindowed[~cut])
    print(f"K3 window 512 over the {int(cut.sum())} slots it cuts: summed max-abs against the "
          f"plain version at 512 {near:.3e}, at 511 {off[0]:.3e}, at 513 {off[1]:.3e}; differs "
          f"from the unwindowed output on every such slot: {differs}; equal on the others: "
          f"{same_short}")
    if not (near < min(off) and differs and same_short):
        raise AssertionError("K3: the sliding window's edge is off")
    q2 = torch.randn(B, 2, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    two = dict(case, lengths=torch.clamp(case["lengths"], min=2))
    compare("int8 fused, two query rows per slot (S=2), pool only", two, q2, False)

    # The split plan's cases (int8 fused pools): one slot (as many splits as
    # the table has pages), 128 slots of 640 tokens (no split), slots with
    # fewer pages than splits, a window whose edge cuts a page in the middle
    # of the splits' shares, and at S = 9 (two row tiles, eight splits) a
    # window whose first page for the tile's later rows is a middle split's.
    def rows(n, S=1):
        return torch.randn(n, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16)

    def news(n):
        return tuple(torch.randn(n, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
                     for _ in range(2))

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = {}
    for label, lens, S, selfterm, window in (
            ("one slot of 2048", [2048], 1, True, None),
            ("one slot of 200 (2 pages)", [200], 1, True, None),
            ("one slot of 2048, window 1000", [2048], 1, True, 1000),
            ("128 slots of 640", [640] * 128, 1, True, None),
            ("4 slots of 60, 130, 300, 2048", [60, 130, 300, 2048], 1, True, None),
            ("2 slots of 2048, 1500 at S=9, window 764", [2048, 1500], 9, False, 764)):
        c = paged_case(gen, lens, True, True)
        n = len(lens)
        plan = pa.split_plan(n, Hkv, S * Hq // Hkv, 16, sms)
        splits[label] = plan.splits
        compare(f"int8 fused, {label} ({plan.tiles} row tile(s), {plan.splits} split(s))", c,
                rows(n, S), selfterm, window, news(n))
    if not (splits["one slot of 2048"] == 16 and splits["128 slots of 640"] == 1
            and splits["2 slots of 2048, 1500 at S=9, window 764"] > 2):
        raise AssertionError(f"K3's split plan changed: {splits}")
    # The splits' merge repeats bit for bit (no float atomics).
    one = paged_case(gen, [2048, 1300, 70, 700], True, True)
    q4, new4 = rows(4), news(4)
    first = paged_call(pa, one, q4, True, *new4)
    again = paged_call(pa, one, q4, True, *new4)
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    print(f"K3 4 slots in {pa.split_plan(4, Hkv, Hq // Hkv, 16, sms).splits} splits: two calls "
          f"equal bit for bit: {same}")
    if not same:
        raise AssertionError("K3: two calls at a split shape differ")

    # Times at lengths like the served path's (prompts of 60 to 800 tokens), int8
    # fused pools with the self-term: what every layer of a decode step calls.
    served = torch.randint(60, 801, (B,), generator=gen, device=dev).tolist()
    case = paged_case(gen, served, True, True)
    ms = median_ms(lambda: paged_call(pa, case, q, True, k_new, v_new))
    device_ms = graph_ms(lambda: paged_call(pa, case, q, True, k_new, v_new))
    plain_ms = median_ms(lambda: paged_call(pa, case, q, True, k_new, v_new, plain=True))
    tokens = sum(served)
    # Each valid K and V row read once with its scale; q, the self-term, the
    # table and the lengths read once; the output written once. 4·Hq·D flops
    # per key (q·k and p·v), counting this run's lengths.
    n_bytes = (tokens * Hkv * 2 * (D + 4) + 2 * 2 * q.numel() + 2 * 2 * k_new.numel()
               + 4 * case["table"].numel() + 8 * B)
    least, by = bound_ms(n_bytes, 4 * Hq * D * (tokens + B))
    print(f"K3 B={B}, {tokens} tokens in the pools (60 to 800 per slot), int8 fused, self-term: "
          f"kernel {ms:.4f} ms per call, {show(device_ms)} on the device; plain (gather + f32 "
          f"matmuls) {plain_ms:.4f} ms; bound {least:.5f} ms by {by} ({n_bytes / 1e6:.2f} MB), "
          f"median of 20")
    full = paged_case(gen, [2048] * B, True, True)
    full_ms = median_ms(lambda: paged_call(pa, full, q, True, k_new, v_new))
    full_device_ms = graph_ms(lambda: paged_call(pa, full, q, True, k_new, v_new))
    full_bytes = B * 2048 * Hkv * 2 * (D + 4)
    print(f"K3 B={B}, every slot at 2048 tokens: kernel {full_ms:.4f} ms per call, "
          f"{show(full_device_ms)} on the device; bound {bound_ms(full_bytes, 0)[0]:.5f} ms by "
          f"bytes ({full_bytes / 1e6:.1f} MB)")
    return {"max_abs_err": worst, "sass": sass, "resources": resources,
            "times": dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=least, bound_by=by),
            "at_2048": dict(ms=full_ms, device_ms=full_device_ms,
                            bound_ms=bound_ms(full_bytes, 0)[0])}


# K3 without the self-term at S query rows per slot (the verify step's shape,
# S = lookahead + 1): 1 to 8, and 9 (36 rows per kv head: two tiles of 32).
VERIFY_ROWS = (1, 2, 3, 4, 5, 6, 7, 8, 9)


def check_paged_attention_rows(gen) -> dict:
    """K3 with S rows already in the pool (`q_offs = lengths - S`, no
    self-term) over int8 fused pools, 32 slots of 60 to 800 tokens, against
    its plain version per slot; times and bound per S. Then bf16 split pools
    at S = 5 with a window of 512, and one S = 5 case whose slots hold only
    their own rows."""
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    Hq, Hkv, D, B = 32, 8, 128, 32
    served = torch.randint(60, 801, (B,), generator=gen, device=dev).tolist()
    case = paged_case(gen, served, True, True)
    tokens = sum(served)
    worst, by_rows = 0.0, []

    def compare(name, c, q, window=None):
        got = paged_call(pa, c, q, False, None, None, window)
        torch.cuda.synchronize()
        want = paged_call(pa, c, q, False, None, None, window, plain=True)
        err = (got.float() - want.float()).abs().flatten(1).amax(dim=1)
        top = want.float().abs().flatten(1).amax(dim=1)
        rel = float(torch.where(top > 0, err / top.clamp_min(1e-30), err).max())
        if not (rel <= 1e-2 and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"K3 {name}: kernel disagrees with the plain version "
                                 f"(per-slot relative max-abs {rel:.3e})")
        return float(err.max()), rel

    for S in VERIFY_ROWS:
        q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
        err, rel = compare(f"S={S}", case, q)
        worst = max(worst, err)
        ms = median_ms(lambda: paged_call(pa, case, q, False, None, None))
        device_ms = graph_ms(lambda: paged_call(pa, case, q, False, None, None))
        plain_ms = median_ms(lambda: paged_call(pa, case, q, False, None, None, plain=True), 10)
        # Each valid K and V row read once with its scale, q and the output
        # once, the table and lengths; 4·Hq·D flops per (query row, key) pair
        # that the causal mask keeps (row j of a slot sees length − S + j + 1 keys).
        pairs = sum(S * (n - S) + S * (S + 1) // 2 for n in served)
        n_bytes = (tokens * Hkv * 2 * (D + 4) + 2 * 2 * q.numel() + 4 * case["table"].numel()
                   + 8 * B)
        least, by = bound_ms(n_bytes, 4 * Hq * D * pairs)
        rows = S * Hq // Hkv
        plan = pa.split_plan(B, Hkv, rows, 16, torch.cuda.get_device_properties(0)
                             .multi_processor_count)
        by_rows.append(dict(S=S, rows_per_kv_head=rows, tiles=plan.tiles, splits=plan.splits,
                            max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                            bound_ms=least, bound_by=by))
        print(f"K3 pool only, S={S} ({rows} query rows per kv head, {plan.tiles} tile(s) of "
              f"{plan.tile_rows}, {plan.splits} split(s)), B={B}, {tokens} tokens, int8 fused: "
              f"max-abs {err:.3e}, per slot relative {rel:.3e} (<= 1e-2); kernel {ms:.4f} ms per "
              f"call, {show(device_ms)} on the device; plain {plain_ms:.4f} ms; bound "
              f"{least:.5f} ms by {by}, median of 20")
    q5 = torch.randn(B, 5, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    wide = paged_case(gen, served, False, False)
    err, rel = compare("bf16 split, S=5, window 512", wide, q5, window=512)
    worst = max(worst, err)
    own = paged_case(gen, [5] * B, True, True)  # the rows are the slot's only keys
    err2, rel2 = compare("int8 fused, S=5, lengths 5", own, q5)
    worst = max(worst, err2)
    print(f"K3 pool only, S=5: bf16 split pools with a window of 512 max-abs {err:.3e} (per slot "
          f"relative {rel:.3e}); slots holding only their 5 rows max-abs {err2:.3e} ({rel2:.3e})")
    return {"max_abs_err": worst, "by_rows": by_rows}


def check_paged_single(gen) -> dict:
    """K3 on rows 7 and 8's contracts. Row 7: the single-row entry
    `paged_attention` (`lengths` tokens in the pool; with the self-term the
    query sits at `lengths`, without it at `lengths - 1`) over bf16 and int8
    split pools, each with and without the self-term and with a window of
    512, at B=32 and the edge lengths of `check_paged_attention`. Row 8:
    `paged_attention_fa(fold_heads=False)` over bf16 and int8 split pools at
    S = 1 and 5, and its refusal of fused pools. Each held against its plain
    version per slot (max-abs error <= 1e-2 of the slot's largest value);
    then times at served lengths (60 to 800 tokens), int8 split pools."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    Hq, Hkv, D, B = 32, 8, 128, 32
    edge = [0, 1, 128, 129, 2048, 2047, 127, 1025]
    lengths = edge + torch.randint(1, 2049, (B - len(edge),), generator=gen, device=dev).tolist()
    q = torch.randn(B, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    worst = 0.0

    def single(case, selfterm, window=None):
        new = dict(k_new=k_new, v_new=v_new) if selfterm else {}
        return pa.paged_attention(q, case["kp"], case["vp"], case["table"], case["lengths"],
                                  sliding_window=window, k_scales=case["ksc"],
                                  v_scales=case["vsc"], page_offset=case["P"], **new)

    def unfolded(case, qq):
        S = qq.shape[1]
        return pa.paged_attention_fa(qq, case["kp"], case["vp"], case["table"], case["lengths"],
                                     (case["lengths"] - S).contiguous(), k_scales=case["ksc"],
                                     v_scales=case["vsc"], page_offset=case["P"],
                                     fold_heads=False)

    def compare(name, fn):
        # Each slot held to its own largest value, as in check_paged_attention.
        nonlocal worst
        got = fn()
        torch.cuda.synchronize()
        with _kernels.plain_versions():
            want = fn()
        err = (got.float() - want.float()).abs().flatten(1).amax(dim=1)
        top = want.float().abs().flatten(1).amax(dim=1)
        rel = float(torch.where(top > 0, err / top.clamp_min(1e-30), err).max())
        print(f"K3 {name}: out max-abs {float(err.max()):.3e}, per slot relative {rel:.3e} "
              f"(<= 1e-2)")
        if not (rel <= 1e-2 and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"K3 {name}: kernel disagrees with the plain version")
        worst = max(worst, float(err.max()))
        return got

    launched = pa.attn_launches
    for quant, label in ((False, "bf16 split"), (True, "int8 split")):
        case = paged_case(gen, lengths, quant, False)
        for selfterm in (False, True):
            for window in (None, 512):
                what = (f"row 7 paged_attention, {label}, "
                        f"{'self-term' if selfterm else 'token in the pool'}"
                        f"{', window 512' if window else ''}")
                got = compare(what, lambda: single(case, selfterm, window))
                if not selfterm and float(got[0].float().abs().max()) != 0.0:
                    raise AssertionError(f"K3 {what}: the slot with no key is not exactly 0")
        for S in (1, 5):
            rows = dict(case, lengths=torch.clamp(case["lengths"], min=S))
            qS = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
            compare(f"row 8 paged_attention_fa(fold_heads=False), {label}, S={S}",
                    lambda: unfolded(rows, qS))
    fused = paged_case(gen, [5] * B, True, True)
    try:
        unfolded(fused, q[:, None])
    except ValueError as e:
        print(f"K3 row 8 over fused pools refused: {e}")
    else:
        raise AssertionError("K3 row 8: fused pools with fold_heads=False were not refused")
    print(f"K3 rows 7 and 8: {pa.attn_launches - launched} kernel launches in the checks")

    # Times at served lengths, int8 split pools: what the writefirst step's
    # layers call (row 7, the token in the pool), row 7 with the self-term
    # (the TPU's `_make_kernel` case), and row 8 at S = 1 and 5.
    served = torch.randint(60, 801, (B,), generator=gen, device=dev).tolist()
    case = paged_case(gen, served, True, False)
    tokens = sum(served)
    q5 = torch.randn(B, 5, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    times = {}
    for key, fn, S, selfterm in (
            ("row 7, token in the pool", lambda: single(case, False), 1, False),
            ("row 7, self-term", lambda: single(case, True), 1, True),
            ("row 8, S=1", lambda: unfolded(case, q[:, None]), 1, False),
            ("row 8, S=5", lambda: unfolded(case, q5), 5, False)):
        ms, device_ms = median_ms(fn), graph_ms(fn)
        with _kernels.plain_versions():
            plain_ms = median_ms(fn, 10)
        # Each valid K and V row read once with its scale, q, the self-term,
        # the table and lengths read once, the output written once; 4·Hq·D
        # flops per (query row, key) pair the causal mask keeps.
        pairs = sum(S * (n - S) + S * (S + 1) // 2 for n in served) + (B if selfterm else 0)
        n_bytes = (tokens * Hkv * 2 * (D + 4) + 2 * 2 * B * S * Hq * D
                   + (2 * 2 * k_new.numel() if selfterm else 0)
                   + 4 * case["table"].numel() + 8 * B)
        least, by = bound_ms(n_bytes, 4 * Hq * D * pairs)
        times[key] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=least, bound_by=by)
        print(f"K3 {key}, B={B}, {tokens} tokens (60 to 800 per slot), int8 split: kernel "
              f"{ms:.4f} ms per call, {show(device_ms)} on the device; plain {plain_ms:.4f} ms; "
              f"bound {least:.5f} ms by {by}; median of 20")
    return {"max_abs_err": worst, "times": times}


def verify_targets(table, lengths, active, S: int, ps: int):
    """Within-layer page ids and offsets [S, B] of a verify step's rows, as
    `_paged_verify_step` computes them: rows past the table forced onto the
    trash page 0, inactive slots there at rows 0..S-1."""
    pps = table.shape[1]
    lengths_eff = torch.where(active, lengths, torch.zeros_like(lengths))
    pos = lengths_eff[:, None] + torch.arange(S, dtype=lengths.dtype, device=lengths.device)
    row_idx = pos // ps
    pages = torch.gather(table, 1, torch.clamp(row_idx, max=pps - 1).long())
    pages = torch.where(active[:, None] & (row_idx < pps), pages, torch.zeros_like(pages))
    return pages.T.contiguous(), (pos % ps).T.contiguous()


def kv_pools(gen, shape, quant: bool, fused: bool):
    """Random pools (and scales) of `shape` [N, Hkv, rows, D]: int8 or bf16,
    KV-fused (v None) or split."""
    dev = "cuda"
    if quant:
        kp = torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        vp = None if fused else torch.randint(-128, 128, shape, generator=gen, device=dev,
                                               dtype=torch.int8)
        ksc = torch.rand(shape[:3], generator=gen, device=dev)
        vsc = None if fused else torch.rand(shape[:3], generator=gen, device=dev)
        return kp, vp, ksc, vsc
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = None if fused else torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    return kp, vp, None, None


POOL_FORMS = ((False, False, "bf16 split"), (False, True, "bf16 fused"),
              (True, False, "int8 split"), (True, True, "int8 fused"))


def check_paged_update(gen) -> dict:
    """K4's absolute-page entry against its plain version, whole pools and
    scales bit for bit, page 0 included (rows that meet on one pool row leave
    the last in (s, b) order, in the kernel and in the plain version), over
    bf16 and int8, split and fused pools:
    - `paged_kv_update_layer{,_q}`, the verify and writefirst steps' form:
      32 slots, S = 1 to 9 rows a slot as projected ([B, S, Hkv, D]), page
      ids and offsets from a page table as the verify step computes them
      (rows of one slot sharing a page and crossing into the next, slots
      whose last rows are forced onto the trash page, inactive slots), layer
      1 of 2; a strided view of a wider block (the writefirst step's
      `k[:, :1]`, and S = 5 of 7 columns);
    - `paged_kv_update{,_q}`, the JAX contract: L = 1 and 2, absolute ids.
    Timed at the verify step's form (int8 fused, B = 32, S = 5): per call,
    on the device, issued back to back; plain, bound, one `index_put_` of
    the quantized rows, and the route the verify step took before (S
    single-row calls a layer, each with its index add and two copies)."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    B, Hkv, D, ps, pps, L = 32, 8, 128, 128, 4, 2
    P = 1 + B * pps
    layer = 1
    table = (torch.randperm(P - 1, generator=gen, device=dev)[:B * pps] + 1).reshape(B, pps)
    table = table.to(torch.int32).contiguous()
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[[2, 9, 21, 30]] = False
    lengths = torch.randint(0, pps * ps - 9, (B,), generator=gen, device=dev)
    # Slots ending past the table (forced rows), starting at a page's last row,
    # and at a page's first.
    lengths[[0, 5, 11]] = torch.tensor([pps * ps - 1, pps * ps - 3, pps * ps - 6], device=dev)
    lengths[[7, 8]] = torch.tensor([ps - 1, 2 * ps], device=dev)
    lengths = lengths.to(torch.int32)

    def write(form, pools, k, v, pages, offsets, base=0):
        kp, vp, ksc, vsc = pools
        if form == "layer":
            if ksc is None:
                pa.paged_kv_update_layer(kp, vp, k, v, pages, offsets, base)
            else:
                pa.paged_kv_update_layer_q(kp, vp, ksc, vsc, k, v, pages, offsets, base)
        elif ksc is None:
            pa.paged_kv_update(kp, vp, k, v, pages, offsets)
        else:
            pa.paged_kv_update_q(kp, vp, ksc, vsc, k, v, pages, offsets)

    def compare(label, form, pools, k, v, pages, offsets, base=0):
        got = [None if t is None else t.clone() for t in pools]
        ref = [None if t is None else t.clone() for t in pools]
        write(form, got, k, v, pages, offsets, base)
        with _kernels.plain_versions():
            write(form, ref, k, v, pages, offsets, base)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, r) for g, r in zip(got, ref) if g is not None)
        changed = int((got[0] != pools[0]).any(dim=-1).sum())
        trash = int((got[0][base] != pools[0][base]).any(dim=-1).sum())
        print(f"K4 {label}: whole pools and scales bit-exact against the plain version, page 0 "
              f"included: {exact} ({changed} rows of the first pool changed, {trash} of them "
              f"on the trash page)")
        if not exact or changed == 0:
            raise AssertionError(f"K4 {label}: kernel disagrees with the plain version")
        return got, ref

    times = None
    shape = (L * P, Hkv, ps, D)
    for quant, fused, label in POOL_FORMS:
        pools = kv_pools(gen, (shape[0], Hkv, 2 * ps if fused else ps, D), quant, fused)
        for S in VERIFY_ROWS:
            pages, offsets = verify_targets(table, lengths, active, S, ps)
            k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            got, ref = compare(f"paged_kv_update_layer, {label}, S={S}", "layer", pools, k, v,
                               pages, offsets, layer * P)
            if quant and fused and S == 5:  # the verify step's form
                times = time_verify_write(pa, _kernels, got, ref, k, v, pages, offsets,
                                          layer * P)
        for S, width in ((1, 4), (5, 7)):  # strided views of a wider block
            pages, offsets = verify_targets(table, lengths, active, S, ps)
            block = torch.randn(B, width, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            compare(f"paged_kv_update_layer, {label}, S={S} strided (columns of {width})",
                    "layer", pools, block[:, :S], block[:, width - S:], pages, offsets, layer * P)
        # The JAX contract: rows [L, B] at absolute ids, offsets [B].
        offs = torch.where(active, torch.randint(0, ps, (B,), generator=gen, device=dev), 0)
        offs = offs.to(torch.int32)
        for n_layers in (1, 2):
            ids = (torch.randperm(shape[0] - 1, generator=gen, device=dev)[:n_layers * B]
                   + 1).reshape(n_layers, B)
            page_ids = torch.where(active[None], ids, 0).to(torch.int32).contiguous()
            k = torch.randn(n_layers, B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn(n_layers, B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
            compare(f"paged_kv_update L={n_layers}, {label}", "update", pools, k, v, page_ids,
                    offs)
        del pools
    return {"max_abs_err": 0.0, "times": times}


def time_verify_write(pa, _kernels, got, ref, k, v, pages, offsets, base) -> dict:
    """The verify step's K4 call (int8 fused, one layer) timed, beside its
    plain version, one `index_put_` of the quantized rows and the old route."""
    B, S, Hkv, D = k.shape
    dev = k.device
    ps = got[0].shape[2] // 2

    def call():
        pa.paged_kv_update_layer_q(got[0], None, got[2], None, k, v, pages, offsets, base)

    def before_call():  # S single-row calls, each with an index add and two copies
        for s in range(S):
            page_ids = (pages[s] + base)[None]
            pa.paged_kv_update_q(got[0], None, got[2], None, k[:, s][None].contiguous(),
                                 v[:, s][None].contiguous(), page_ids, offsets[s])

    kq, vq = pa.quantize_kv(k)[0], pa.quantize_kv(v)[0]
    page = (pages.T.long() + base)[:, :, None]             # [B, S, 1]
    head = torch.arange(Hkv, device=dev)[None, None, :]
    row = offsets.T.long()[:, :, None]
    index = (torch.cat([page, page]), head, torch.cat([row, row + ps]))
    both = torch.cat([kq, vq])

    def library_call():  # the write half only
        ref[0].index_put_(index, both)

    out = {}
    for label, fn in (("kernel", call), ("before", before_call), ("library", library_call)):
        out[label] = dict(ms=median_ms(fn), device_ms=graph_ms(fn), issue_ms=issue_ms(fn))
    with _kernels.plain_versions():
        plain_ms = median_ms(call)
    # bf16 rows read once; int8 rows and f32 scales written once; ids and
    # offsets read once.
    n_rows = 2 * B * S * Hkv
    least, by = bound_ms(n_rows * (2 * D + D + 4) + 2 * 4 * S * B, 0)
    print(f"K4 paged_kv_update_layer_q, B={B}, S={S}, int8 fused (a verify step's layer): "
          f"kernel {out['kernel']['ms']:.4f} ms per call, {show(out['kernel']['device_ms'])} on "
          f"the device, issued back to back {out['kernel']['issue_ms']:.4f}; plain (quantize + "
          f"4 indexed writes) {plain_ms:.4f}; one index_put_ of quantized rows "
          f"{out['library']['ms']:.4f} ({show(out['library']['device_ms'])} on the device); "
          f"bound {least:.6f} ms by {by}; before ({S} single-row calls with their copies) "
          f"{out['before']['ms']:.4f} per call, {show(out['before']['device_ms'])} on the "
          f"device, issued {out['before']['issue_ms']:.4f}; median of 20")
    return dict(ms=out["kernel"]["ms"], device_ms=out["kernel"]["device_ms"],
                issue_ms=out["kernel"]["issue_ms"], plain_ms=plain_ms,
                library_ms=out["library"]["ms"], library_device_ms=out["library"]["device_ms"],
                bound_ms=least, bound_by=by, before=out["before"])


def check_paged_rows(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    L, B, Hkv, D, ps, P = 32, 32, 8, 128, 128, 65
    active = torch.ones(B, dtype=torch.bool, device=dev)
    active[[3, 4, 11, 17, 18, 19, 30, 31]] = False
    # An active slot writes its own page at any row; inactive slots all write
    # row 0 of trash page 0, where the last of them in slot order wins, in the
    # kernel as in the plain version.
    pages = torch.where(active, torch.randperm(P - 1, generator=gen, device=dev)[:B] + 1, 0)
    offsets = torch.where(active, torch.randint(0, ps, (B,), generator=gen, device=dev), 0)
    pages, offsets = pages.to(torch.int32), offsets.to(torch.int32)
    ks = torch.randn(L, B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    vs = torch.randn(L, B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    times = None
    for quant, fused, label in POOL_FORMS:
        kp, vp, ksc, vsc = kv_pools(gen, (L * P, Hkv, 2 * ps if fused else ps, D), quant, fused)
        got = [None if t is None else t.clone() for t in (kp, vp, ksc, vsc)]
        ref = [None if t is None else t.clone() for t in (kp, vp, ksc, vsc)]
        if quant:
            pa.paged_kv_update_rows_q(*got, ks, vs, pages, offsets)
            with _kernels.plain_versions():
                pa.paged_kv_update_rows_q(*ref, ks, vs, pages, offsets)
        else:
            pa.paged_kv_update_rows(got[0], got[1], ks, vs, pages, offsets)
            with _kernels.plain_versions():
                pa.paged_kv_update_rows(ref[0], ref[1], ks, vs, pages, offsets)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, r) for g, r in zip(got, ref) if g is not None)
        changed = int((got[0] != kp).any(dim=-1).sum())
        print(f"K4 {label}: whole pools and scales bit-exact against the plain version: {exact} "
              f"({changed} rows of the first pool changed)")
        if not exact or changed == 0:
            raise AssertionError(f"K4 {label}: kernel disagrees with the plain version")
        if quant and fused:  # the served path's form
            def call():
                pa.paged_kv_update_rows_q(*got, ks, vs, pages, offsets)

            ms, device_ms, issue = median_ms(call), graph_ms(call), issue_ms(call)
            with _kernels.plain_versions():
                plain_ms = median_ms(lambda: pa.paged_kv_update_rows_q(*ref, ks, vs, pages, offsets))
            # The library call nearest to it: ONE indexed write of rows that are
            # already quantized (the write half of the function only).
            kq, vq = pa.quantize_kv(ks)[0], pa.quantize_kv(vs)[0]
            page = (torch.arange(L, device=dev)[:, None] * P + pages.long()[None, :])[:, :, None]
            head = torch.arange(Hkv, device=dev)[None, None, :]
            row = offsets.long()[None, :, None]
            index = (torch.cat([page, page]), head, torch.cat([row.expand(L, B, 1),
                                                               row.expand(L, B, 1) + ps]))
            both = torch.cat([kq, vq])
            def library_call():
                ref[0].index_put_(index, both)

            library_ms, library_device_ms = median_ms(library_call), graph_ms(library_call)
            # bf16 rows read once; int8 rows and f32 scales written once.
            n_rows = 2 * L * B * Hkv
            least, by = bound_ms(n_rows * (2 * D + D + 4) + 8 * B, 0)
            times = dict(ms=ms, device_ms=device_ms, issue_ms=issue, plain_ms=plain_ms,
                         library_ms=library_ms, library_device_ms=library_device_ms,
                         bound_ms=least, bound_by=by)
            print(f"K4 paged_kv_rows, {label} (a decode step, L={L}, B={B}): kernel {ms:.4f} ms "
                  f"per call, {show(device_ms)} on the device, issued back to back "
                  f"{issue:.4f}; plain (quantize + 4 indexed writes) {plain_ms:.4f} ms, one "
                  f"index_put_ of quantized rows {library_ms:.4f} ms "
                  f"({show(library_device_ms)} on the device), bound {least:.6f} ms by {by}, "
                  f"median of 20")
    return {"max_abs_err": 0.0, "times": times}


# (K, N) of every int8 projection: the decoder's q/o, k/v, gate/up and down,
# and the Q-Former's packed self in_proj, cross q / out_proj, cross k/v, ffn.0
# and ffn.2.
QMM_SHAPES = {"decoder q, o": (4096, 4096), "decoder k, v": (4096, 1024),
              "decoder gate, up": (4096, 14336), "decoder down": (14336, 4096),
              "Q-Former in_proj": (4096, 12288), "Q-Former cross k, v": (5120, 4096),
              "Q-Former ffn.0": (4096, 8192), "Q-Former ffn.2": (8192, 4096)}
QMM_ROWS = (1, 7, 32, 128)


def int8_library_call(x, weight_q, scale):
    """The yardstick for K5: `torch._weight_int8pack_mm` where this PyTorch has
    it on CUDA (and it agrees), else dequantize + `torch.matmul`. Used nowhere
    in the port. Returns (name, fn)."""
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    want = qmm.quantized_matmul_plain(x, weight_q, scale).float()
    for name, s in (("torch._weight_int8pack_mm", scale), ("torch._weight_int8pack_mm", scale.to(x.dtype))):
        try:
            got = torch._weight_int8pack_mm(x, weight_q, s).float()
        except (RuntimeError, NotImplementedError, AttributeError, TypeError):
            continue
        if float((got - want).abs().max()) <= 2e-2 * float(want.abs().max()):
            return f"{name} (scales {s.dtype})", lambda: torch._weight_int8pack_mm(x, weight_q, s)
    return "dequantize + torch.matmul", lambda: x @ qmm.dequantize(weight_q, scale, x.dtype).T


QMM_SASS_OPS = ("HGMMA", "UTMALDG", "PRMT", "LOP3", "I2F")
# One decoder pass at M rows runs q, k, v, o, gate, up, down in 32 layers.
QMM_PASS = (("decoder q, o", 2), ("decoder k, v", 2), ("decoder gate, up", 2), ("decoder down", 1))


def qmm_sass(label: str, function: str, no_i2f: bool):
    """K5's or K6's SASS (every n instantiation) and resources: it must hold
    HGMMA and UTMALDG, and K6 no I2F (its nibbles convert by lop3)."""
    sass, res = sass_counts(function, QMM_SASS_OPS), resource_usage(function)
    print(f"{label} SASS ({function}, its five n): {sass}; registers at entry {res['reg']}, stack "
          f"frame {res['stack']} bytes, local {res['local']}")
    if not (sass["HGMMA"] and sass["UTMALDG"]):
        raise AssertionError(f"{label}: no HGMMA or UTMALDG in its SASS: {sass}")
    if no_i2f and sass["I2F"]:
        raise AssertionError(f"{label}: its SASS converts with I2F: {sass}")
    return sass, res


def time_qmm(kernel, plain, library, bf16) -> dict:
    """The kernel three ways: CUDA events around one call (the host's launch
    path included, as K1 to K4 are timed), the device time alone (CUDA-graph
    replay), and the host's issue time when calls go back to back; the plain
    version by events; the library call by events and on the device; the
    bf16 weights' `F.linear` (cuBLAS) on the device."""
    return dict(ms=median_ms(kernel), device_ms=graph_ms(kernel), issue_ms=issue_ms(kernel),
                plain_ms=median_ms(plain, 10), library_ms=median_ms(library, 10),
                library_device_ms=graph_ms(library), bf16_device_ms=graph_ms(bf16))


def pass_totals(label: str, times: dict) -> dict:
    """Each timing summed over one decoder pass, per M."""
    passes = {}
    for M in QMM_ROWS:
        total = {}
        for key, value in times[(QMM_PASS[0][0], M)].items():
            if isinstance(value, str):
                continue
            vals = [times[(name, M)][key] for name, _ in QMM_PASS]
            total[key] = (None if None in vals
                          else 32 * sum(n * v for (_, n), v in zip(QMM_PASS, vals)))
        passes[M] = total
        share = ("not measured" if total["device_ms"] is None
                 else f"{100 * total['bound_ms'] / total['device_ms']:.1f} %")
        print(f"{label} one decoder pass at M={M} (224 launches): kernel {show(total['ms'])} ms per "
              f"call summed, {show(total['device_ms'])} on the device ({share} of the bound), "
              f"issued back to back {show(total['issue_ms'])}; library {show(total['library_ms'])} "
              f"by events, {show(total['library_device_ms'])} on the device; bf16 weights "
              f"(F.linear) {show(total['bf16_device_ms'])} on the device; plain "
              f"{show(total['plain_ms'])}; bound {total['bound_ms']:.3f} ms")
    return passes


def check_quant_matmul(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    dev = "cuda"
    sass, res = qmm_sass("K5", "qmm_kernelILi8E", no_i2f=False)
    worst = 0.0
    times = {}
    library = None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(name, K, N, M) for name, (K, N) in QMM_SHAPES.items() for M in QMM_ROWS]
    # Edges the served shapes do not reach: a K % 64 tail, ragged N, f32 output.
    cases += [("edge: K % 64 = 48, ragged N", 4144, 1000, 33), ("edge: K = 16", 16, 72, 5)]
    for name, K, N, M in cases:
        wq = torch.randint(-127, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand(N, generator=gen, device=dev) + 0.5) * (2.0 / (127 * K ** 0.5))
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        for xx in ((x, x.float()) if name.startswith("edge") else (x,)):
            got = qmm.quantized_matmul(xx, wq, scale)
            torch.cuda.synchronize()
            want = qmm.quantized_matmul_plain(xx, wq, scale)
            # Each row is held to its own largest value (a bf16 ulp is at most
            # 0.78 % of a value): per-row max-abs error over the row's max |plain|.
            err = (got.float() - want.float()).abs().amax(dim=1)
            rel = float((err / want.float().abs().amax(dim=1).clamp_min(1e-30)).max())
            if not (got.dtype == xx.dtype and got.shape == (M, N) and rel <= 1e-2
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K5 {name} M={M} {xx.dtype}: kernel disagrees with the plain "
                                     f"version (per-row relative max-abs {rel:.3e})")
            worst = max(worst, float(err.max()))
        if name.startswith("edge"):
            print(f"K5 {name} (K={K}, N={N}, M={M}), bf16 and f32 output: per-row max-abs over the "
                  f"row's largest value {rel:.3e} (<= 1e-2)")
            continue
        name_of_library, lib_fn = int8_library_call(x, wq, scale)
        if library is None:
            library = name_of_library
            print(f"K5 library yardstick: {library}")
        dense = qmm.dequantize(wq, scale, torch.bfloat16)
        t = time_qmm(lambda: qmm.quantized_matmul(x, wq, scale),
                     lambda: qmm.quantized_matmul_plain(x, wq, scale), lib_fn,
                     lambda: torch.nn.functional.linear(x, dense))
        del dense
        # x, the int8 weight and the scales read once, the bf16 output written
        # once; 2·M·N·K tensor-core operations.
        least, by = bound_ms(2 * M * K + N * K + 4 * N + 2 * M * N, 2 * M * N * K)
        plan = qmm.schedule(M, N, K, sms)
        times[(name, M)] = dict(t, bound_ms=least, bound_by=by)
        print(f"K5 {name} (K={K}, N={N}) M={M}: kernel {t['ms']:.4f} ms per call, "
              f"{show(t['device_ms'])} on the device ({plan.tiles} tiles x {plan.splits} K "
              f"splits), issued back to back {t['issue_ms']:.4f}; plain (f32 matmul) "
              f"{t['plain_ms']:.4f}; library {t['library_ms']:.4f} by events, "
              f"{show(t['library_device_ms'])} on the device; bf16 F.linear "
              f"{show(t['bf16_device_ms'])} on the device; bound {least:.5f} ms by {by} "
              f"({(N * K) / 1e6:.1f} MB of weights); per-row error {rel:.2e}")
    passes = pass_totals("K5", times)
    headline = times[("decoder gate, up", 32)]
    return {"max_abs_err": worst, "library": library, "passes": passes, "sass": sass,
            "resources": res,
            "times": {key: headline[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by", "device_ms", "issue_ms",
                                                     "library_device_ms", "bf16_device_ms")}}


# (K, N) of every int4 projection: the decoder's q/o, k/v, gate/up and down (the
# Q-Former stays int8 under --load-4bit).
QMM4_SHAPES = {name: QMM_SHAPES[name] for name in
               ("decoder q, o", "decoder k, v", "decoder gate, up", "decoder down")}


def int4_library_call(x, weight_q4, scale4):
    """The yardstick for K6: `torch._weight_int4pack_mm` after
    `torch._convert_weight_to_int4pack` (codes + 8 as uint4, two to a byte,
    bf16 scales, zero points 0) where this PyTorch runs it on CUDA and it
    agrees, else dequantize + `torch.matmul` (the name says why). Used
    nowhere in the port. Returns (name, fn)."""
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    want = qmm.quantized_matmul_int4_plain(x, weight_q4, scale4).float()
    N, G = scale4.shape
    K = x.shape[1]
    try:
        codes = qmm.unpack_int4(weight_q4, G).to(torch.int32) + 8        # [N, K] in 1..15
        packed = ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8)  # [N, K/2]
        w = torch._convert_weight_to_int4pack(packed, 8)
        scales_zeros = torch.stack([scale4.T, torch.zeros_like(scale4.T)], dim=-1)
        scales_zeros = scales_zeros.to(torch.bfloat16).contiguous()        # [G, N, 2]
        fn = lambda: torch._weight_int4pack_mm(x, w, K // G, scales_zeros)  # noqa: E731
        err = float((fn().float() - want).abs().max())
        if err <= 2e-2 * float(want.abs().max()):
            return "torch._weight_int4pack_mm (bf16 scales)", fn
        why = f"torch._weight_int4pack_mm disagrees, max-abs {err:.3e}"
    except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
        why = f"torch._weight_int4pack_mm does not run: {str(e).splitlines()[0][:100]}"
    return (f"dequantize + torch.matmul ({why})",
            lambda: x @ qmm.dequant_int4(weight_q4, scale4, x.dtype).T)


def check_quant_matmul_int4(gen) -> dict:
    from vis_zephyr_tpu_torch.ops import quant as quant_ops
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    dev = "cuda"
    sass, res = qmm_sass("K6", "qmm_kernelILi4E", no_i2f=True)
    worst = 0.0
    times = {}
    library = None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(name, K, N, M, 128) for name, (K, N) in QMM4_SHAPES.items() for M in QMM_ROWS]
    # Edges the served shapes do not reach: one group, a 256-wide group, f32 x.
    cases += [("edge: one group, K = 128", 128, 384, 5, 128), ("edge: group 256", 1024, 256, 33, 256)]
    for name, K, N, M, group in cases:
        w = torch.randn(N, K, generator=gen, device=dev) * K ** -0.5
        wq4, scale4 = quant_ops.quantize_kernel_int4(w, group)
        del w
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        for xx in ((x, x.float()) if name.startswith("edge") else (x,)):
            got = qmm.quantized_matmul_int4(xx, wq4, scale4)
            torch.cuda.synchronize()
            want = qmm.quantized_matmul_int4_plain(xx, wq4, scale4)
            # Each row is held to its own largest value, as K5's: per-row max-abs
            # error over the row's max |plain|.
            err = (got.float() - want.float()).abs().amax(dim=1)
            rel = float((err / want.float().abs().amax(dim=1).clamp_min(1e-30)).max())
            if not (got.dtype == xx.dtype and got.shape == (M, N) and rel <= 1e-2
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K6 {name} M={M} {xx.dtype}: kernel disagrees with the plain "
                                     f"version (per-row relative max-abs {rel:.3e})")
            worst = max(worst, float(err.max()))
        if name.startswith("edge"):
            print(f"K6 {name} (K={K}, N={N}, M={M}), bf16 and f32 x: per-row max-abs over the "
                  f"row's largest value {rel:.3e} (<= 1e-2)")
            continue
        name_of_library, lib_fn = int4_library_call(x, wq4, scale4)
        if library is None:
            library = name_of_library
            print(f"K6 library yardstick: {library}")
        dense = qmm.dequant_int4(wq4, scale4, torch.bfloat16)
        t = time_qmm(lambda: qmm.quantized_matmul_int4(x, wq4, scale4),
                     lambda: qmm.quantized_matmul_int4_plain(x, wq4, scale4), lib_fn,
                     lambda: torch.nn.functional.linear(x, dense))
        del dense
        # The nibbles, the f32 group scales and x read once, the bf16 output
        # written once; 2·M·N·K tensor-core operations.
        G = K // group
        least, by = bound_ms(N * K // 2 + 4 * N * G + 2 * M * K + 2 * M * N, 2 * M * N * K)
        plan = qmm.schedule(M, N, K, sms, group)
        times[(name, M)] = dict(t, bound_ms=least, bound_by=by)
        print(f"K6 {name} (K={K}, N={N}) M={M}: kernel {t['ms']:.4f} ms per call, "
              f"{show(t['device_ms'])} on the device ({plan.tiles} tiles x {plan.splits} K "
              f"splits), issued back to back {t['issue_ms']:.4f}; plain (f32 group matmuls) "
              f"{t['plain_ms']:.4f}; library {t['library_ms']:.4f} by events, "
              f"{show(t['library_device_ms'])} on the device; bf16 F.linear "
              f"{show(t['bf16_device_ms'])} on the device; bound {least:.5f} ms by {by} "
              f"({N * K / 2e6:.1f} MB of nibbles); per-row error {rel:.2e}")
    passes = pass_totals("K6", times)
    m1 = times[("decoder gate, up", 1)]
    print(f"K6 gate/up at M=1 on the device: {show(m1['device_ms'])} ms against the library call's "
          f"{show(m1['library_device_ms'])}")
    headline = times[("decoder gate, up", 32)]
    return {"max_abs_err": worst, "library": library, "passes": passes, "sass": sass,
            "resources": res,
            "times": {key: headline[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by", "device_ms", "issue_ms",
                                                     "library_device_ms", "bf16_device_ms")}}


def int8_mlp_library_call(x, weights):
    """A yardstick for K9: `torch._weight_int8pack_mm` for gate, up and down
    with `F.silu` between them, where this PyTorch runs it on CUDA and it
    agrees with the plain version, else None. Used nowhere in the port.
    Returns (name, fn) or (reason, None)."""
    from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as probe

    gate_q, gate_s, up_q, up_s, down_q, down_s = weights
    want = probe.fused_mlp_matvec_plain(x, *weights).float()

    def fn(cast):
        g = torch._weight_int8pack_mm(x, gate_q, gate_s.to(cast))
        u = torch._weight_int8pack_mm(x, up_q, up_s.to(cast))
        return torch._weight_int8pack_mm(torch.nn.functional.silu(g) * u, down_q, down_s.to(cast))

    why = "torch._weight_int8pack_mm does not run"
    for cast in (torch.float32, x.dtype):
        try:
            err = float((fn(cast).float() - want).abs().max())
        except (RuntimeError, NotImplementedError, AttributeError, TypeError) as e:
            why = f"torch._weight_int8pack_mm does not run: {str(e).splitlines()[0][:100]}"
            continue
        if err <= 2e-2 * float(want.abs().max()):
            return f"torch._weight_int8pack_mm x 3 + F.silu (scales {cast})", lambda: fn(cast)
        why = f"torch._weight_int8pack_mm disagrees, max-abs {err:.3e}"
    return why, None


MLP_ROWS = (1, 8)


def check_fused_mlp(gen) -> dict:
    """K9 against `fused_mlp_matvec_plain` at Zephyr-7B's widths (D = 4096,
    I = 14336) with random int8 weights and scales from the seed, at M = 1
    and 8 and both tilings (block_i 64 and 128): max-abs error over max
    |plain| <= 1e-2 (a bf16 ulp is at most 0.78 % of a value; h and y round
    once on both sides, in other orders) and cosine >= 0.9999. Times per
    call (events around one call and the device alone from a CUDA-graph
    replay) beside the plain version, the K5 route a `--load-8bit` layer
    takes (K5 gate, up, `F.silu(g) · u`, K5 down) and the int8-pack yardstick."""
    from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as probe
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    dev = "cuda"
    hidden, inter = probe.D, probe.I

    def codes(n, k):
        return torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)

    def scales(n, k):
        return (torch.rand(n, generator=gen, device=dev) + 0.5) * (2.0 / (127 * k ** 0.5))

    weights = (codes(inter, hidden), scales(inter, hidden), codes(inter, hidden),
               scales(inter, hidden), codes(hidden, inter), scales(hidden, inter))
    worst, times = 0.0, {}
    library = None
    for M in MLP_ROWS:
        x = torch.randn(M, hidden, generator=gen, device=dev).to(torch.bfloat16)
        want = probe.fused_mlp_matvec_plain(x, *weights)
        for bi in probe.BLOCK_I:
            got = probe.fused_mlp_matvec(x, *weights, block_i=bi)
            torch.cuda.synchronize()
            a = probe.agreement(got, want)
            print(f"K9 fused_mlp_matvec M={M}, block_i {bi}: max-abs over max |plain| "
                  f"{a['rel_err']:.3e} (<= 1e-2), cosine {a['cosine']:.7f} (>= 0.9999)")
            if not (got.shape == (M, hidden) and a["rel_err"] <= 1e-2 and a["cosine"] >= 0.9999
                    and bool(torch.isfinite(got.float()).all())):
                raise AssertionError(f"K9 M={M} block_i {bi}: kernel disagrees with the plain "
                                     "version")
            worst = max(worst, float((got.float() - want.float()).abs().max()))
        # x and the three int8 weights with their scales read once, y written
        # once; 2·M multiply-adds per weight byte.
        least, by = bound_ms(3 * hidden * inter + 4 * (2 * inter + hidden) + 4 * M * hidden,
                             2 * 3 * M * hidden * inter)
        t = {}
        for bi in probe.BLOCK_I:
            fn = lambda bi=bi: probe.fused_mlp_matvec(x, *weights, block_i=bi)  # noqa: E731
            t[bi] = dict(ms=median_ms(fn), device_ms=graph_ms(fn))
        k5 = lambda: probe.k5_route(x, *weights)  # noqa: E731
        k5_ms, k5_device = median_ms(k5), graph_ms(k5)
        plain_ms = median_ms(lambda: probe.fused_mlp_matvec_plain(x, *weights), 10)
        name, lib_fn = int8_mlp_library_call(x, weights)
        if library is None:
            library = name
            print(f"K9 yardstick: {library}")
        lib_ms = None if lib_fn is None else median_ms(lib_fn, 10)
        best = min(probe.BLOCK_I, key=lambda bi: t[bi]["device_ms"] or t[bi]["ms"])
        times[M] = dict(ms=t[probe.DEFAULT_BLOCK_I]["ms"],
                        device_ms=t[probe.DEFAULT_BLOCK_I]["device_ms"],
                        by_block_i={bi: t[bi] for bi in probe.BLOCK_I}, plain_ms=plain_ms,
                        library_ms=None, k5_route_ms=k5_ms, k5_route_device_ms=k5_device,
                        int8pack_route_ms=lib_ms, bound_ms=least, bound_by=by)
        for bi in probe.BLOCK_I:
            print(f"K9 M={M}, block_i {bi}: {t[bi]['ms']:.4f} ms per call, "
                  f"{show(t[bi]['device_ms'])} on the device")
        print(f"K9 M={M}: the K5 route {k5_ms:.4f} ms per call, {show(k5_device)} on the device; "
              f"plain (f32 matmuls) {plain_ms:.4f}; {library}: {show(lib_ms)}; bound {least:.5f} "
              f"ms by {by} ({3 * hidden * inter / 1e6:.1f} MB of int8 weights); fastest tiling "
              f"on the device: block_i {best}")
    return {"max_abs_err": worst, "times": times}


class WordTokenizer:
    """A stand-in tokenizer with the surface `tokenize_with_images` and
    `ChatEngine` use: words hash to ids, every id decodes to "w<id>"."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 2

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text, **kwargs):
        ids = [self.bos_token_id]
        for word in text.replace("</s>", " </s> ").split():
            ids.append(self.eos_token_id if word == "</s>"
                       else 3 + zlib.crc32(word.encode()) % (self.vocab_size - 3))
        return self._Out(ids)

    def decode(self, ids, skip_special_tokens=False):
        # Every id stays a word (EOS ends a stream before it is decoded), so
        # the streamed word count is the generated token count.
        return " ".join(f"w{i}" for i in ids)


def post_chat(port: int, payload: dict):
    """POST /chat; returns (status, text, seconds to first chunk, seconds to end)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/chat", body=json.dumps(payload),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    chunks, first = [], None
    while True:
        data = resp.read1(65536)
        if not data:
            break
        if first is None:
            first = time.perf_counter() - t0
        chunks.append(data)
    total = time.perf_counter() - t0
    conn.close()
    return resp.status, b"".join(chunks).decode(), first, total


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(), dim=0))


def build_model(seed: int):
    from vis_zephyr_tpu_torch.config import VisZephyrConfig
    from vis_zephyr_tpu_torch.models.vis_zephyr import init_vis_zephyr

    cfg = VisZephyrConfig()
    t0 = time.perf_counter()
    model = init_vis_zephyr(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda",
                            dtype=torch.bfloat16)
    # No random reply may end early: the EOS row of lm_head is zeroed, so its
    # logit is 0 and never the largest of 32000 random ones. Every reply then
    # has exactly max_new_tokens tokens and the launch counts are exact.
    model.decoder.lm_head.weight[WordTokenizer.eos_token_id].zero_()
    torch.cuda.synchronize()
    n_params = {name: sum(p.numel() for p in getattr(model, name).parameters())
                for name in ("vision", "projector", "decoder")}
    print(f"model: full-width VisZephyrConfig() with random bf16 weights "
          f"(vision {n_params['vision'] / 1e9:.2f} B, projector {n_params['projector'] / 1e9:.2f} B, "
          f"decoder {n_params['decoder'] / 1e9:.2f} B params) in {time.perf_counter() - t0:.1f} s")
    return model, cfg


def session_pixels(rng, side: int, crops: int):
    """Seeded pixels [4, side, side, 3] with `crops` valid patches, as
    `attach_image` stores a preprocessed image (no PIL on the card's host)."""
    import numpy as np

    px = rng.standard_normal((4, side, side, 3)).astype(np.float32)
    px[crops:] = 0.0
    return px, np.arange(4) < crops


def start_server(engine):
    from vis_zephyr_tpu_torch.serve.api import serve

    server = serve(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def stop_server(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)


def weight_bits(model) -> int:
    """16, 8 or 4: the form of the decoder's projections."""
    from vis_zephyr_tpu_torch.models.quant_linear import QuantLinear, QuantLinear4

    up = model.decoder.model.layers[0].mlp.up_proj
    return 4 if isinstance(up, QuantLinear4) else 8 if isinstance(up, QuantLinear) else 16


def reset_routes() -> None:
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    qmm.launches = qmm.dequant_calls = qmm.launches4 = qmm.dequant4_calls = 0


def read_routes() -> dict:
    """K5 and K6 launches and their dequantize routes' calls since the last reset."""
    from vis_zephyr_tpu_torch.ops import quant_matmul as qmm

    return dict(k5=qmm.launches, dequant=qmm.dequant_calls, k6=qmm.launches4,
                dequant4=qmm.dequant4_calls)


def expected_routes(model, qformer, decoder) -> dict:
    """What `read_routes` must give after a run whose Q-Former passes route as
    `qformer` and whose decoder passes as `decoder` ((kernel, dequantize)
    pairs): on int8 weights K5 takes both, on int4 weights K5 the Q-Former's
    and K6 the decoder's; on bf16 weights nothing is quantized."""
    bits = weight_bits(model)
    int8 = {16: (0, 0), 8: add_routes(qformer, decoder), 4: qformer}[bits]
    int4 = decoder if bits == 4 else (0, 0)
    return dict(k5=int8[0], dequant=int8[1], k6=int4[0], dequant4=int4[1])


def show_routes(got: dict, want: dict) -> str:
    return (f"K5 quant_matmul_int8 {got['k5']} (want {want['k5']}), its dequantize route "
            f"{got['dequant']} (want {want['dequant']}); K6 quant_matmul_int4 {got['k6']} (want "
            f"{want['k6']}), its dequantize route {got['dequant4']} (want {want['dequant4']})")


def qformer_routes(cfg, n_images: int, text_len: int):
    """(K5 launches, dequantize-route calls) of one int8 Q-Former pass over
    `n_images` crops conditioned on `text_len` prompt tokens. Per block: the
    packed self in_proj, the self out_proj, the cross q and out_proj, ffn.0 and
    ffn.2 at the query rows (block 0's queries are followed by the text), the
    cross k and v at the visual rows."""
    from vis_zephyr_tpu_torch.ops.quant_matmul import row_chunks

    pc = cfg.projector
    query_rows = ([n_images * (pc.num_queries + text_len)]
                  + [n_images * pc.num_queries] * (pc.num_blocks - 1))
    visual_rows = n_images * cfg.vision.tokens_per_image
    calls = [m for rows in query_rows for m in [rows] * 6 + [visual_rows] * 2]
    return (sum(len(row_chunks(m)) for m in calls), sum(not row_chunks(m) for m in calls))


def decoder_routes(cfg, rows: int, passes: int = 1):
    """(kernel launches, dequantize-route calls) of `passes` quantized decoder
    passes of `rows` rows each: q, k, v, o, gate, up and down in every layer,
    224 at full depth, all on one route (K5 on int8 weights; K6 on int4, whose
    gate the full-width shapes pass whole), a launch a chunk of rows
    (`row_chunks`)."""
    from vis_zephyr_tpu_torch.ops.quant_matmul import row_chunks

    n = 7 * cfg.decoder.num_layers * passes
    chunks = len(row_chunks(rows))
    return (n * chunks, 0) if chunks else (0, n)


def add_routes(*routes):
    return tuple(map(sum, zip(*routes))) if routes else (0, 0)


def run_slice(model, cfg, seed: int, max_new_tokens: int, card: str, n_requests: int = 4,
              label: str = "slice1") -> dict:
    import numpy as np

    from vis_zephyr_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve.engine import ChatEngine
    from vis_zephyr_tpu_torch.serve.generate import _cache_len, decode_step, prefill

    L = cfg.decoder.num_layers
    tokenizer = WordTokenizer(cfg.decoder.vocab_size)
    engine = ChatEngine(model, cfg, tokenizer, max_new_tokens=max_new_tokens)
    rng = np.random.default_rng(seed)
    side = cfg.vision.image_size
    sessions = [f"s{i}" for i in range(3)]
    pixels = {}
    for sid in sessions:
        px, valid = session_pixels(rng, side, 3)
        pixels[sid] = px
        engine.attach_pixels(sid, px, valid, (2 * side, side))

    server, thread = start_server(engine)
    port = server.server_address[1]
    # A session's first turn carries the <image> placeholder, as `chat` adds
    # it when it attaches an image itself.
    requests = [(sessions[0], f"{DEFAULT_IMAGE_TOKEN}\ndescribe the picture"),
                (sessions[1], f"{DEFAULT_IMAGE_TOKEN}\nwhat is in the image"),
                (sessions[2], f"{DEFAULT_IMAGE_TOKEN}\ncount the objects"),
                (sessions[0], "and what colour is it")][:n_requests]
    results = []
    try:
        fa.launches = kv_cache.launches = 0
        reset_routes()
        for sid, question in requests:
            status, text, ttft, total = post_chat(port, {"session_id": sid, "question": question})
            n = len(text.split())
            results.append((sid, status, text, ttft, total, n))
        flash_launches, append_launches = fa.launches, kv_cache.launches
        routes = read_routes()
    finally:
        stop_server(server, thread)

    decode_steps = 0
    rates = []
    for sid, status, text, ttft, total, n in results:
        words_ok = n > 0 and all(w[0] == "w" and w[1:].isdigit() for w in text.split())
        print(f"{label} request {sid}: HTTP {status}, {n} tokens streamed, TTFT {ttft * 1e3:.1f} ms, "
              f"total {total * 1e3:.1f} ms, text starts {text[:48]!r}")
        if status != 200 or not words_ok:
            raise AssertionError(f"request on {sid} did not stream text")
        decode_steps += min(n, max_new_tokens - 1)
        if n > 1:
            rates.append((n - 1) / (total - ttft))
    # Quantized weights: each first-turn request runs one Q-Former pass over its
    # 4 crops and one prefill over the spliced rows (the prompt without its
    # sentinel and 4 crops' tokens, padded to 128), then a decode step (M = 1)
    # per token after the first.
    qformer, prefills = [], []
    if weight_bits(model) != 16:
        assert all(q.startswith(DEFAULT_IMAGE_TOKEN) for _, q in requests), "first turns only"
        for _, question in requests:
            n_ids = len(engine.prompt_ids(question))
            rows = -(-(n_ids - 1 + 4 * cfg.tokens_per_patch) // 128) * 128
            qformer.append(qformer_routes(cfg, 4, n_ids - 1))
            prefills.append(decoder_routes(cfg, rows))
    want = expected_routes(model, add_routes(*qformer),
                           add_routes(*prefills, decoder_routes(cfg, 1, decode_steps)))
    print(f"{label} counters: K1 flash_fwd {flash_launches} launches (want {L * len(requests)}), "
          f"K2 dense_cache_append {append_launches} (want {L} x {decode_steps} decode steps), "
          f"{show_routes(routes, want)}")
    if (flash_launches != L * len(requests) or append_launches != L * decode_steps
            or routes != want):
        raise AssertionError("the serving path did not go through the kernels as counted")

    # Kernel path against the plain path on session s1's request.
    ids = torch.tensor([engine.prompt_ids(requests[1][1])], device="cuda")
    images = torch.as_tensor(pixels[sessions[1]], device="cuda")[None]
    valid = torch.tensor([[True, True, True, False]], device="cuda")
    # The cache length `generate_stream` picks, so the kernel path's greedy
    # tokens must equal the streamed ones exactly.
    cache_len = _cache_len(ids.shape[1], images, cfg, max_new_tokens)
    last_k, cache_k, lengths = prefill(model, ids, images, valid, cfg, cache_len)
    with _kernels.plain_versions():
        last_p, cache_p, _ = prefill(model, ids, images, valid, cfg, cache_len)
    if not (bool(torch.isfinite(last_k).all()) and last_k.shape == (1, cfg.decoder.vocab_size)):
        raise AssertionError(f"prefill logits not finite of shape [1, V]: {tuple(last_k.shape)}")
    cos_prefill = cosine(last_k, last_p)
    token = last_k.argmax(-1)
    direct = [int(token)]
    for _ in range(8):
        logits_k, cache_k = decode_step(model, cache_k, token, cfg)
        with _kernels.plain_versions():
            logits_p, cache_p = decode_step(model, cache_p, token, cfg)
        token = logits_k.argmax(-1)
        direct.append(int(token))
    cos_decode = cosine(logits_k, logits_p)
    streamed = [int(w[1:]) for w in results[1][2].split()][:len(direct)]
    same_tokens = direct[:len(streamed)] == streamed  # a stream ends early only at EOS
    print(f"{label} check (prefill length {int(lengths[0])}, padded to a multiple of 128): "
          f"prefill last-token logits cosine {cos_prefill:.6f}, decode-step-8 logits cosine "
          f"{cos_decode:.6f} (kernel path vs the kernels' plain versions, >= 0.999); "
          f"direct greedy tokens equal the streamed ones: {same_tokens}")
    if not (cos_prefill >= 0.999 and cos_decode >= 0.999 and bool(torch.isfinite(logits_k).all())):
        raise AssertionError("kernel path disagrees with the plain path")
    if not same_tokens:
        raise AssertionError(f"served tokens {streamed} differ from a direct run's {direct}")

    ttfts = [r[3] for r in results]
    rate = statistics.median(rates) if rates else float("nan")
    print(f"{label}: TTFT median {statistics.median(ttfts) * 1e3:.1f} ms (first request "
          f"{ttfts[0] * 1e3:.1f} ms), decode {rate:.2f} tokens/s median over requests, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    return {"k1": flash_launches, "k2": append_launches, **routes,
            "precision_inputs": (ids, images, valid, cache_len, last_k)}


def check_precision(model, cfg, ids, images, valid, cache_len, last_k) -> None:
    """The port runs the multimodal prefill in bf16, while the JAX engine's f32
    pixels promote its vision stack and prefill to f32 over the same bf16
    weights. Hold the kernel path's logits against that arithmetic: the same
    weights widened to f32 (exactly), plain attention. Widens `model` in place."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.serve.generate import prefill

    model.float()
    with _kernels.plain_versions():
        last_f32, _, _ = prefill(model, ids, images, valid, cfg, cache_len)
    cos_f32 = cosine(last_k, last_f32)
    same_top1 = int(last_k.argmax(-1)) == int(last_f32.argmax(-1))
    print(f"precision: bf16 kernel-path prefill last-token logits against an f32 run of "
          f"the same weights: cosine {cos_f32:.6f} (>= 0.999), max-abs "
          f"{float((last_k - last_f32).abs().max()):.4e}, same top-1 token: {same_top1}")
    if not cos_f32 >= 0.999:
        raise AssertionError("bf16 prefill disagrees with the f32 run of the same weights")


# -- the batched paged path -------------------------------------------------------------

PAGED_FLAGS = ["--continuous-batching", "--kv-cache", "paged", "--kv-quant", "--max-slots", "32"]
QUESTION_WORDS = (20, 280, 580)
WORDS = ("the picture shows a street with people cars trees shops and signs under a "
         "bright sky while someone asks what is happening here and why").split()


def make_question(rng, n_words: int) -> str:
    return " ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), n_words))


def paged_requests(rng, cfg, n: int, repeat: bool = False):
    """[(session id, question, pixels, valid)]: question lengths cycle through
    about 40, 300 and 600 words; every third session's image has 3 valid
    anyres crops, the others the global view alone (`/chat` takes no session
    without an image). `repeat`: each question is one 10-word phrase said
    over and over (for prompt lookup to find)."""
    from vis_zephyr_tpu_torch.constants import DEFAULT_IMAGE_TOKEN

    out = []
    for i in range(n):
        px, valid = session_pixels(rng, cfg.vision.image_size, 3 if i % 3 == 0 else 1)
        n_words = QUESTION_WORDS[(i // 3) % 3]
        text = (" ".join([make_question(rng, 10)] * (n_words // 10)) if repeat
                else make_question(rng, n_words))
        question = f"{DEFAULT_IMAGE_TOKEN}\n" + text
        out.append((f"p{i}", question, px, valid))
    return out


def run_paged_server(model, cfg, seed: int, new_tokens: int, card: str, n: int = 48,
                     label: str = "paged", lookahead: int = 0, repeat: bool = False,
                     multi_step: int = 1) -> dict:
    """The paged server under a burst of `n` concurrent /chat requests, with
    `--lookahead` when `lookahead` > 0 (then every scheduler step is a verify
    step of S = lookahead + 1 rows per slot) and `--multi-step` (a scheduler
    step with no admission work waiting runs that many decode steps, each
    counted in `steps`); `repeat`: repetitive questions (`paged_requests`)."""
    import numpy as np

    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve import api

    L = cfg.decoder.num_layers
    parser = argparse.ArgumentParser()
    api.add_engine_args(parser)
    flags = parser.parse_args(PAGED_FLAGS + ["--max-new-tokens", str(new_tokens),
                                             "--lookahead", str(lookahead),
                                             "--multi-step", str(multi_step)])
    engine = api.engine_from_args(model, cfg, WordTokenizer(cfg.decoder.vocab_size), flags)
    b = engine.batcher
    side = cfg.vision.image_size
    requests = paged_requests(np.random.default_rng(seed + 1), cfg, n, repeat=repeat)
    chunks = 0
    qformer = []  # quantized weights: one Q-Former pass per request, at admission
    for sid, question, px, valid in requests:
        engine.attach_pixels(sid, px, valid, (2 * side, side))
        n_ids = len(engine.prompt_ids(question))
        length = n_ids - 1 + int(valid.sum()) * cfg.tokens_per_patch
        chunks += -(-length // b.prefill_chunk)
        qformer.append(qformer_routes(cfg, px.shape[0], n_ids - 1))
    print(f"{label}: server flags {' '.join(PAGED_FLAGS)} -> max_slots {b.max_slots}, cache_len "
          f"{b.cache_len}, page {b.page_size}, {b.num_pages} pages per layer, prefill chunk "
          f"{b.prefill_chunk}, int8 {b.kv_quant}, fused {b.kv_fused}, lookahead {b.lookahead}; pools "
          f"{(b.kp.numel() + 4 * b.ksp.numel()) / 2**30:.2f} GiB")

    # Warm the path once (cuBLAS handles, allocator), outside the counted run.
    engine.attach_pixels("warm", requests[0][2], requests[0][3], (2 * side, side))
    engine.chat_text("warm", requests[0][1])
    uses = np.zeros(b.max_slots, np.int64)
    install = b._install

    def counting_install(req, slot, *args):
        ok = install(req, slot, *args)
        uses[slot] += bool(ok)
        return ok

    b._install = counting_install
    server, thread = start_server(engine)
    port = server.server_address[1]
    torch.cuda.reset_peak_memory_stats()
    try:
        fa.launches = kv_cache.launches = pa.attn_launches = pa.rows_launches = 0
        pa.update_launches = 0
        reset_routes()
        b.steps = b.slots_stepped = b.verify_steps = b.proposed = b.accepted = b.bursts = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            results = list(pool.map(
                lambda r: post_chat(port, {"session_id": r[0], "question": r[1]}), requests))
        wall = time.perf_counter() - t0
        counts = dict(k1=fa.launches, k2=kv_cache.launches, k3=pa.attn_launches,
                      k4=pa.rows_launches, kvu=pa.update_launches, **read_routes())
    finally:
        stop_server(server, thread)
        engine.close()

    for (sid, _, _, _), (status, text, ttft, total) in zip(requests, results):
        words = text.split()
        if status != 200 or len(words) != new_tokens or not all(
                w[0] == "w" and w[1:].isdigit() for w in words):
            raise AssertionError(f"{label} request {sid}: HTTP {status}, {len(words)} tokens "
                                 f"(want {new_tokens}): {text[:60]!r}")
    S = lookahead + 1
    steps = b.verify_steps if lookahead else b.steps
    kind = f"verify steps (S = {S})" if lookahead else "decode steps"
    bursts = (f" ({b.bursts} bursts of {b.multi_step} = {b.bursts * b.multi_step} of them, "
              f"{b.graphs.captures} capture)" if multi_step > 1 else "")
    print(f"{label}: {n} requests, all HTTP 200 with {new_tokens} tokens; {steps} {kind}{bursts}, "
          f"mean active slots per step {b.slots_stepped / steps:.2f} of {b.max_slots}")
    if multi_step > 1 and b.bursts == 0:
        raise AssertionError(f"{label}: no scheduler step ran a burst")
    # Quantized weights: every chunk (256 rows) takes the dequantize route,
    # every decode step (M = max_slots) the kernel, every verify step (M =
    # max_slots x S) whichever route its rows take; plus each request's
    # Q-Former pass.
    want = expected_routes(model, add_routes(*qformer),
                           add_routes(decoder_routes(cfg, b.prefill_chunk, chunks),
                                      decoder_routes(cfg, b.max_slots * S, steps)))
    routes = {key: counts[key] for key in want}
    # A decode step: K3 once per layer and K4 once over all layers. A verify
    # step: K3 once per layer over S rows, and one write of the layer's S rows
    # a slot (`paged_kv_update_layer`), no all-layer write.
    k4_want, kvu_want = (0, L * steps) if lookahead else (steps, 0)
    print(f"{label} counters: K3 paged_attn_decode {counts['k3']} (want {L} x {steps} = {L * steps}), "
          f"K4 paged_kv_rows {counts['k4']} (want {k4_want}), K4 paged_kv_update {counts['kvu']} "
          f"(want {kvu_want}), K2 dense_cache_append {counts['k2']} "
          f"(want {L} x {chunks} prefill chunks = {L * chunks}), K1 flash_fwd {counts['k1']} (want 0: "
          f"chunked admission attends its scratch cache with plain attention), "
          f"{show_routes(routes, want)}")
    if ((counts["k3"], counts["k4"], counts["kvu"], counts["k2"], counts["k1"])
            != (L * steps, k4_want, kvu_want, L * chunks, 0) or routes != want
            or (lookahead and (b.steps != 0 or steps == 0))):
        raise AssertionError("the paged serving path did not go through the kernels as counted")
    if lookahead:
        emitted = n * (new_tokens - 1)  # every token after each request's first
        counts.update(verify_steps=steps, proposed=b.proposed, accepted=b.accepted)
        print(f"{label} speculation: {b.proposed} tokens proposed, {b.accepted} accepted "
              f"({b.accepted / max(b.proposed, 1):.3f}); {emitted / b.slots_stepped:.3f} tokens "
              f"per slot per verify step")
    reused = int((uses > 1).sum())
    free = b.allocator.available
    print(f"{label} slots: {int((uses > 0).sum())} of {b.max_slots} used, {reused} of them more than "
          f"once ({int(uses.sum())} admissions); allocator {free} of {b.num_pages - 1} pages free, "
          f"page table all zero: {not bool(b.page_table.any())}")
    # Fewer requests than slots need not reuse a slot.
    if (int(uses.sum()) != n or (reused == 0 and n > b.max_slots) or free != b.num_pages - 1
            or b.has_work or bool(b.page_table.any()) or b.slots_stepped <= steps):
        raise AssertionError("slots were not reused, requests did not share steps, or pages leaked")
    ttfts = sorted(r[2] for r in results)
    decoded = n * (new_tokens - 1)
    print(f"{label}: TTFT median {statistics.median(ttfts) * 1e3:.1f} ms, max {ttfts[-1] * 1e3:.1f} ms; "
          f"{n * new_tokens} tokens in {wall:.2f} s = {n * new_tokens / wall:.1f} tokens/s over all "
          f"slots ({decoded / wall:.1f} decode tokens/s), {wall / steps * 1e3:.1f} ms of wall per "
          f"scheduler step (decode + one prefill chunk), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]")
    counts.update(tokens_per_s=n * new_tokens / wall, ttft_median=statistics.median(ttfts),
                  streams={sid: text.split() for (sid, *_), (_, text, _, _) in zip(requests, results)})
    return counts


def admitted_batcher(model, cfg, requests, max_slots: int, prefill_chunk=None,
                     max_new_tokens: int = 64, **kw):
    """A direct PagedBatcher with every request admitted before any decode
    step: whole (the prompt prefills through K1) or, with `prefill_chunk`, in
    chunks over a scratch cache (K2 at T = chunk). Inside
    `_kernels.plain_versions()` the same admission takes the plain versions."""
    from vis_zephyr_tpu_torch.serve.generate import SamplingConfig
    from vis_zephyr_tpu_torch.serve.paged import PagedBatcher

    b = PagedBatcher(model, cfg, max_slots=max_slots, cache_len=2048,
                     sampling=SamplingConfig(max_new_tokens=max_new_tokens, eos_token_id=-1),
                     prefill_chunk=prefill_chunk, **kw)
    for ids, px, valid in requests:
        b.submit(ids, px, valid)
    if prefill_chunk:
        while not b.pending.empty() or b._prefilling is not None:
            b._pump_prefill()
    else:
        b._admit_pending()
    if int(b.active.sum()) != len(requests):
        raise AssertionError("not every request was admitted")
    return b


def direct_requests(cfg, seed: int, n: int):
    import numpy as np

    from vis_zephyr_tpu_torch.data.tokenization import tokenize_with_images

    tok = WordTokenizer(cfg.decoder.vocab_size)
    return [(np.asarray(tokenize_with_images(q, tok), np.int64), px, valid)
            for _, q, px, valid in paged_requests(np.random.default_rng(seed + 2), cfg, n)]


def slot_cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)


def valid_rows(b, L: int) -> torch.Tensor:
    """Bool [L·P, Hkv, rows]: the K and V rows below each slot's length (a
    prefill's padded tail holds rows nothing reads, filled differently by the
    two prefill paths)."""
    ps, P = b.page_size, b.num_pages
    valid = torch.zeros(b.ksp.shape, dtype=torch.bool, device=b.ksp.device)
    layer0 = torch.arange(L, device=valid.device) * P
    for slot in range(b.max_slots):
        n = int(b.slot_len[slot])
        for j, page in enumerate(b.slot_pages[slot]):
            rows = min(max(n - j * ps, 0), ps)
            valid[layer0 + page, :, :rows] = True
            valid[layer0 + page, :, ps:ps + rows] = True
    return valid


def run_fixed_batch(model, cfg, seed: int) -> dict:
    """HTTP timing changes which requests share a step, so agreement is read on
    a fixed batch: the same 16 requests admitted whole (K1) and in chunks of 256
    (K2 at T=256), each on the kernel path and on the plain path, and whole with
    bf16 pools; all are fed the whole-prompt kernel path's tokens so that they
    see the same sequence. Returns K2's launches of the chunked admission, the
    tokens fed before each step and the kernel path's logits at steps 1 and 16
    (the int8 phase replays them)."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    L = cfg.decoder.num_layers
    requests = direct_requests(cfg, seed, 16)
    int8_fused = dict(kv_quant=True, kv_fused=True)
    fa.launches = kv_cache.launches = 0
    kern = admitted_batcher(model, cfg, requests, 16, **int8_fused)
    k1 = fa.launches
    chunk_kern = admitted_batcher(model, cfg, requests, 16, prefill_chunk=256, **int8_fused)
    k2 = kv_cache.launches
    with _kernels.plain_versions():
        plain = admitted_batcher(model, cfg, requests, 16, **int8_fused)
        chunk_plain = admitted_batcher(model, cfg, requests, 16, prefill_chunk=256, **int8_fused)
    wide = admitted_batcher(model, cfg, requests, 16, kv_quant=False, kv_fused=True)
    chunks = sum(-(-int(n) // 256) for n in kern.slot_len)
    print(f"batch: 16 requests, prompt lengths {sorted(int(n) for n in kern.slot_len)}; admitted "
          f"whole: K1 flash_fwd {k1} launches (want {L} per prompt = {L * 16}); admitted in chunks "
          f"of 256: K2 dense_cache_append {k2} launches (want {L} x {chunks} chunks = {L * chunks})")
    if (k1, k2) != (L * 16, L * chunks):
        raise AssertionError("the admissions did not go through K1 and K2 as counted")

    # Chunked admission runs the same arithmetic on both paths but for K's
    # RoPE and the row write (K2, which repeats eager PyTorch's roundings,
    # against `apply_rope` and the indexed write), so everything it leaves
    # behind must be equal bit for bit: pools, scales, table, lengths, tokens.
    rows = valid_rows(chunk_kern, L)
    same = {"int8 rows": torch.equal(chunk_kern.kp[rows], chunk_plain.kp[rows]),
            "scales": torch.equal(chunk_kern.ksp[rows], chunk_plain.ksp[rows]),
            "whole pools": (torch.equal(chunk_kern.kp, chunk_plain.kp)
                            and torch.equal(chunk_kern.ksp, chunk_plain.ksp)),
            "page table": torch.equal(chunk_kern.page_table, chunk_plain.page_table),
            "lengths": torch.equal(chunk_kern.lengths, chunk_plain.lengths),
            "first tokens": torch.equal(chunk_kern.token, chunk_plain.token)}
    print(f"batch chunked admission, kernel path (K2 at B=1, T=256 into scratch caches of "
          f"{sorted({-(-int(n) // 256) * 256 for n in kern.slot_len})} rows) against the plain path, "
          f"{int(rows.sum())} K and V rows below the slots' lengths; bit-equal: {same}")
    if not all(same.values()):
        raise AssertionError("chunked admission through K2 differs from its plain version")

    others = (plain, wide, chunk_kern, chunk_plain)
    for other in others:
        other.token.copy_(kern.token)
    fed, logits = [kern.token.clone()], {}
    for step in range(1, 17):
        for b in (kern, wide, chunk_kern):
            if b.step() != 16:
                raise AssertionError("a slot finished early")
        with _kernels.plain_versions():
            for b in (plain, chunk_plain):
                if b.step() != 16:
                    raise AssertionError("a slot finished early")
        if step in (1, 16):
            logits[step] = kern.last_logits.clone()
            cos_plain = slot_cosines(kern.last_logits, plain.last_logits)
            cos_wide = slot_cosines(kern.last_logits, wide.last_logits)
            cos_chunk = slot_cosines(chunk_kern.last_logits, chunk_plain.last_logits)
            cos_route = slot_cosines(chunk_kern.last_logits, kern.last_logits)
            print(f"batch step {step}: logits cosine, minimum over the 16 slots: kernel path vs "
                  f"plain path, admitted whole {float(cos_plain.min()):.6f}, admitted in chunks "
                  f"{float(cos_chunk.min()):.6f} (>= 0.999); chunked vs whole admission "
                  f"{float(cos_route.min()):.6f} (>= 0.999); int8 pools vs bf16 pools min "
                  f"{float(cos_wide.min()):.6f} median {float(cos_wide.median()):.6f} (>= 0.99)")
            if not (min(float(cos_plain.min()), float(cos_chunk.min()),
                        float(cos_route.min())) >= 0.999 and float(cos_wide.min()) >= 0.99
                    and bool(torch.isfinite(kern.last_logits).all())
                    and bool(torch.isfinite(chunk_kern.last_logits).all())):
                raise AssertionError("the batched kernel path disagrees")
        for other in others:
            other.token.copy_(kern.token)
        fed.append(kern.token.clone())

    # The two whole-prompt int8 runs' pools. Their K/V rows come from bf16
    # activations that differ in the last bits between the paths (K1 against
    # plain attention), so an int8 value may move by a few steps and a scale by
    # a bf16 ulp or two (0.4 to 0.8 % each): "every value within 1, every
    # scale within 1e-3" cannot hold between two bf16 paths. The gates sit just under
    # what this comparison reads on an H100 (0.9996 / 0.960 / one to two ulps),
    # so a wrong row write by K4 or by admission fails them.
    valid = valid_rows(kern, L)
    diff = (kern.kp.int() - plain.kp.int()).abs()[valid]
    rel = ((kern.ksp - plain.ksp).abs() / kern.ksp.clamp_min(1e-30))[valid]
    deq_k = pa.dequant_kv_pool(kern.kp, kern.ksp, torch.float32)[valid]
    deq_p = pa.dequant_kv_pool(plain.kp, plain.ksp, torch.float32)[valid]
    cos_rows = slot_cosines(deq_k, deq_p)
    within_1 = float((diff <= 1).float().mean())
    print(f"batch pools after 16 steps, the {int(valid.sum())} K and V rows below the slots' "
          f"lengths: int8 values max |diff| {int(diff.max())}, within 1: {within_1:.6f} of all "
          f"(>= 0.95); scales relative diff median {float(rel.median()):.2e}, max "
          f"{float(rel.max()):.2e} (<= 5e-2), within 1e-3: "
          f"{float((rel <= 1e-3).float().mean()):.4f}; dequantized rows cosine min "
          f"{float(cos_rows.min()):.6f} (>= 0.999), mean {float(cos_rows.mean()):.6f} (>= 0.9995)")
    if not (float(cos_rows.min()) >= 0.999 and float(cos_rows.mean()) >= 0.9995
            and within_1 >= 0.95 and float(rel.max()) <= 5e-2
            and torch.equal(kern.page_table, plain.page_table)
            and torch.equal(kern.lengths, plain.lengths)):
        raise AssertionError("the kernel path's pools disagree with the plain path's")
    # After the steps too, the chunked pair: the decode rows K4 wrote.
    rows = valid_rows(chunk_kern, L)
    cos_rows = slot_cosines(pa.dequant_kv_pool(chunk_kern.kp, chunk_kern.ksp, torch.float32)[rows],
                            pa.dequant_kv_pool(chunk_plain.kp, chunk_plain.ksp, torch.float32)[rows])
    print(f"batch pools after 16 steps, admitted in chunks: dequantized rows cosine min "
          f"{float(cos_rows.min()):.6f} (>= 0.999)")
    if not float(cos_rows.min()) >= 0.999:
        raise AssertionError("the chunked kernel path's pools disagree with the plain path's")
    return {"k2": k2, "fed": fed, "logits": logits}


# -- the writefirst decode step ------------------------------------------------------


def run_writefirst(model, cfg, seed: int) -> dict:
    """The fixed batch of 16, admitted whole, stepped 16 times by
    `_paged_step(mode="writefirst")` and by `mode="selfterm"` on two copies
    of its state, over bf16 split and int8 fused pools; both steps are fed
    the selfterm step's tokens, so that every step compares one sequence.
    Gates: logits cosine >= 0.999 per slot at every step; exactly 32 K3 and
    32 `paged_kv_update` launches per writefirst step and no all-layer row
    write. The greedy tokens' agreement is printed, not gated: on random
    full-width weights the top logits of a slot lie closer together than two
    bf16 arithmetic orders' difference (PERF.md, Findings), so a different
    token there is a tie broken apart; for each such flip the selfterm
    step's margin between the two tokens is printed beside the slot's
    largest logit difference. The CPU test holds the tokens equal (f32, tiny
    model).
    Returns the writefirst steps' launch counts."""
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve.paged import _paged_step

    L = cfg.decoder.num_layers
    requests = direct_requests(cfg, seed, 16)
    counts = {"k3": 0, "kvu": 0}
    for quant, fused, label in ((False, False, "bf16 split"), (True, True, "int8 fused")):
        b = admitted_batcher(model, cfg, requests, 16, kv_quant=quant, kv_fused=fused)
        active = torch.ones(16, dtype=torch.bool, device=b.device)
        state = {mode: [None if t is None else t.clone()
                        for t in (b.kp, b.vp, b.ksp, b.vsp, b.lengths, b.token)]
                 for mode in ("writefirst", "selfterm")}
        agree, cos_min, flips = [], 1.0, []
        for step in range(1, 17):
            state["writefirst"][5].copy_(state["selfterm"][5])
            out = {}
            for mode in ("writefirst", "selfterm"):
                kp, vp, ksp, vsp, lengths, token = state[mode]
                before = (pa.attn_launches, pa.update_launches, pa.rows_launches)
                _, logits = _paged_step(model, kp, vp, (ksp, vsp), b.page_table, lengths, token,
                                        active, None, cfg, b.sampling, mode=mode)
                got = (pa.attn_launches - before[0], pa.update_launches - before[1],
                       pa.rows_launches - before[2])
                if mode == "writefirst":
                    if got != (L, L, 0):
                        raise AssertionError(f"writefirst {label} step {step}: launches K3, "
                                             f"paged_kv_update, paged_kv_rows {got}, want "
                                             f"({L}, {L}, 0)")
                    counts["k3"] += got[0]
                    counts["kvu"] += got[1]
                out[mode] = (token.clone(), logits)
            cos = slot_cosines(out["writefirst"][1], out["selfterm"][1])
            cos_min = min(cos_min, float(cos.min()))
            (tok_w, log_w), (tok_s, log_s) = out["writefirst"], out["selfterm"]
            agree.append(int((tok_w == tok_s).sum()))
            for slot in torch.nonzero(tok_w != tok_s)[:, 0].tolist():
                margin = float(log_s[slot, tok_s[slot]] - log_s[slot, tok_w[slot]])
                flips.append((margin, float((log_w[slot] - log_s[slot]).abs().max())))
            if step in (1, 16):
                print(f"writefirst {label} step {step}: logits cosine against the selfterm step, "
                      f"minimum over the 16 slots {float(cos.min()):.6f} median "
                      f"{float(cos.median()):.6f} (>= 0.999); same greedy token on "
                      f"{agree[-1]} of 16 slots")
            if not (float(cos.min()) >= 0.999
                    and bool(torch.isfinite(out["writefirst"][1]).all())):
                raise AssertionError(f"writefirst {label} step {step}: disagrees with selfterm")
        same_lengths = torch.equal(state["writefirst"][4], state["selfterm"][4])
        print(f"writefirst {label}, 16 steps fed the selfterm step's tokens: logits cosine min "
              f"{cos_min:.6f} (>= 0.999 every step); same greedy token on {sum(agree)} of 256 "
              f"(per step {agree}); lengths equal {same_lengths}; launches per step K3 {L}, "
              f"paged_kv_update {L}, paged_kv_rows 0")
        if flips:
            print(f"writefirst {label}: the {len(flips)} different tokens, the selfterm step's "
                  f"margin between its token and writefirst's against the slot's largest logit "
                  f"difference: " + ", ".join(f"{m:.4f}/{d:.4f}" for m, d in flips))
        if not same_lengths:
            raise AssertionError(f"writefirst {label}: lengths differ from the selfterm step's")
        del b, state, out
        torch.cuda.empty_cache()
    return counts


def device_items(prof, n: int):
    """Kernel rows of a torch.profiler run of `n` steps: [(name, ms per step,
    launches per step)], largest first, and their sum (device busy per step;
    one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType

    def device_us(e):  # the attribute's name changed between PyTorch releases
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    # Kernel rows only: an operator's row repeats the time of the kernels it launched.
    rows = [(e.key, device_us(e) / 1e3 / n, e.count / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return rows, sum(r[1] for r in rows)


def run_step_profile(model, cfg, seed: int, card: str) -> None:
    """One 32-slot decode step (int8 fused pools) in each mode, side by side
    on one batch: wall (host clock around steps that end in a synchronize,
    the modes taken in turns), device busy, idle share and the largest device
    items (torch.profiler), and `paged_kv_update`'s device time per launch."""
    from torch.profiler import ProfilerActivity, profile

    from vis_zephyr_tpu_torch.serve.paged import _paged_step

    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True)
    active = torch.ones(32, dtype=torch.bool, device=b.device)
    modes = ("writefirst", "selfterm")

    def step(mode):
        _paged_step(model, b.kp, b.vp, (b.ksp, b.vsp), b.page_table, b.lengths, b.token, active,
                    None, cfg, b.sampling, mode=mode)

    for mode in modes * 2:
        step(mode)
    torch.cuda.synchronize()
    walls = {mode: [] for mode in modes}
    for _ in range(8):
        for mode in modes:
            t0 = time.perf_counter()
            step(mode)
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3)
    n = 4
    for mode in modes:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(mode)
            torch.cuda.synchronize()
        rows, busy = device_items(prof, n)
        wall = statistics.median(walls[mode])
        print(f"writefirst profile: {mode} decode step, B=32 active slots, int8 fused pools, "
              f"lengths about {int(b.lengths.float().mean())}: wall median {wall:.2f} ms (8 steps, "
              f"min {min(walls[mode]):.2f}, max {max(walls[mode]):.2f}), device busy {busy:.2f} "
              f"ms per step, idle share {1 - busy / wall:.2f} [{card}]")
        for key, ms, count in rows[:8]:
            print(f"writefirst profile:   {ms:8.3f} ms  {count:6.1f} launches/step  {key[:90]}")
        for key, ms, count in rows:
            if "paged_kv_rows_kernel" in key:
                print(f"writefirst profile: {mode}: K4 (`paged_kv_rows_kernel`) {ms:.4f} ms per "
                      f"step over {count:.1f} launches: {ms / count * 1e3:.2f} us per launch on "
                      f"the device [{card}]")
        if busy <= 0:
            print("writefirst profile: the profiler reported no device time")


# -- the fused int8 MLP matvec probe (K9) -------------------------------------------------


def run_mlp_layer(mlp, hidden: int, norm_weight, eps: float, label: str, card: str) -> None:
    """K9 on one int8 decoder layer's MLP, as `--load-8bit` leaves it, at M = 1
    against `mlp(hn)` (the K5 route, which rounds g, u and their product to
    bf16 each, where K9 rounds h once): cosine >= 0.999."""
    from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as probe
    from vis_zephyr_tpu_torch.models.mistral import rms_norm

    gen = torch.Generator("cuda").manual_seed(7)
    h = torch.randn(1, hidden, generator=gen, device="cuda").to(torch.bfloat16)
    hn = rms_norm(h, norm_weight, eps)
    got = probe.fused_mlp_matvec(hn, *probe.quantized_mlp_weights(mlp))
    want = mlp(hn)
    torch.cuda.synchronize()
    a = probe.agreement(got, want)
    print(f"mlp_probe: K9 on {label} at M=1 against layer.mlp(hn): cosine {a['cosine']:.6f} "
          f"(>= 0.999), max-abs over max |mlp(hn)| {a['rel_err']:.3e} [{card}]")
    if not (a["cosine"] >= 0.999 and bool(torch.isfinite(got.float()).all())):
        raise AssertionError(f"mlp_probe: K9 disagrees with {label}'s mlp")


def standalone_int8_mlp(seed: int):
    """A full-width decoder MLP with random bf16 weights from `seed`
    (PyTorch's fan-in init), quantized as `load_8bit` quantizes a layer."""
    from vis_zephyr_tpu_torch.config import VisZephyrConfig
    from vis_zephyr_tpu_torch.models.mistral import MistralMLP
    from vis_zephyr_tpu_torch.ops.quant import quantize_linear

    dec = VisZephyrConfig().decoder
    torch.manual_seed(seed)
    mlp = MistralMLP(dec, device="cuda", dtype=torch.bfloat16)
    for name in ("gate_proj", "up_proj", "down_proj"):
        setattr(mlp, name, quantize_linear(getattr(mlp, name)))
    return mlp, dec.hidden_size, torch.ones(dec.hidden_size, device="cuda",
                                            dtype=torch.bfloat16), dec.rms_norm_eps


def quantize_model(seed: int, card: str, bits: int = 8):
    """The full-width model with random bf16 weights from `seed` (the same as
    the bf16 phases'), quantized in place by `load_8bit`'s (`bits` 8) or
    `load_4bit`'s (`bits` 4) step (`models/builder.py::quantize_weights`):
    decoder layers in `bits`, Q-Former projections in int8, one layer at a
    time."""
    from vis_zephyr_tpu_torch.models.builder import quantize_weights

    model, cfg = build_model(seed)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    quantize_weights(model, bits=bits)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    def gib(module):
        return sum(t.numel() * t.element_size()
                   for t in list(module.parameters()) + list(module.buffers())) / 2**30

    decoder = model.decoder
    layers = gib(decoder.model.layers)
    kept = gib(decoder) - layers
    flag = f"load_{bits}bit"
    print(f"int{bits}: {flag} quantized the decoder layers and the Q-Former in {seconds:.1f} s; "
          f"device memory {before / 2**30:.2f} GiB before, {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB after, peak while quantizing {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"weights: vision {gib(model.vision):.2f} GiB bf16, Q-Former {gib(model.projector):.2f} "
          f"GiB int8, decoder layers {layers:.2f} GiB int{bits}, embed + lm_head + norms "
          f"{kept:.2f} GiB bf16; in all {gib(model):.2f} GiB [{card}]")
    if weight_bits(model) != bits:
        raise AssertionError(f"{flag} left the decoder in another form")
    return model, cfg


def run_fixed_batch_quant(model, cfg, seed: int, bf16: dict, card: str, int8=None) -> dict:
    """The fixed batch of 16 on quantized weights, admitted whole: the kernel
    path against the plain path, and against the bf16 weights' kernel path
    (and, on int4 weights, the int8 one's), all fed the bf16 run's tokens;
    K5, K6 and dequantize-route counts exact. Returns the kernel path's
    logits at steps 1 and 16."""
    from vis_zephyr_tpu_torch.ops import _kernels

    bits = weight_bits(model)
    label = f"int{bits} batch"
    requests = direct_requests(cfg, seed, 16)
    int8_fused = dict(kv_quant=True, kv_fused=True)
    reset_routes()
    kern = admitted_batcher(model, cfg, requests, 16, **int8_fused)
    admitted = read_routes()
    # Whole admission: one Q-Former pass and one prefill per prompt, of its
    # spliced rows (the prompt without its sentinel and 4 crops' tokens)
    # padded to 128.
    want = expected_routes(
        model, add_routes(*(qformer_routes(cfg, px.shape[0], len(ids) - 1) for ids, px, _ in requests)),
        add_routes(*(decoder_routes(cfg, -(-(len(ids) - 1 + px.shape[0] * cfg.tokens_per_patch)
                                          // 128) * 128) for ids, px, _ in requests)))
    lengths = sorted(int(n) for n in kern.slot_len)
    with _kernels.plain_versions():
        plain = admitted_batcher(model, cfg, requests, 16, **int8_fused)
    reset_routes()
    logits = {}
    for step in range(1, 17):
        for b in (kern, plain):
            b.token.copy_(bf16["fed"][step - 1])
        if kern.step() != 16:
            raise AssertionError("a slot finished early")
        counted = read_routes()
        with _kernels.plain_versions():
            if plain.step() != 16:
                raise AssertionError("a slot finished early")
        if read_routes() != counted:
            raise AssertionError("the plain path launched a kernel")
        if step in (1, 16):
            logits[step] = kern.last_logits.clone()
            cos_plain = slot_cosines(kern.last_logits, plain.last_logits)
            cos_bf16 = slot_cosines(kern.last_logits, bf16["logits"][step])
            line = (f"{label} step {step}: logits cosine, minimum over the 16 slots: kernel path vs "
                    f"plain path {float(cos_plain.min()):.6f} (>= 0.999); int{bits} weights vs bf16 "
                    f"weights min {float(cos_bf16.min()):.6f} median {float(cos_bf16.median()):.6f}")
            if bits == 8:
                # int8 against bf16 weights read 0.998075 to 0.998123 (min over
                # slots) on an H100: the gate sits just under that.
                line += " (>= 0.997)"
                good = float(cos_bf16.min()) >= 0.997
            else:
                # Random weights say nothing of int4's quality (its rounding
                # step is about 13 times int8's): read, not gated.
                good = True
                if int8 is not None:
                    cos_int8 = slot_cosines(kern.last_logits, int8[step])
                    line += (f"; vs int8 weights min {float(cos_int8.min()):.6f} median "
                             f"{float(cos_int8.median()):.6f} (not gated)")
            print(line)
            if not (float(cos_plain.min()) >= 0.999 and good
                    and bool(torch.isfinite(kern.last_logits).all())):
                raise AssertionError(f"the int{bits} kernel path disagrees")
    stepped = read_routes()
    want_steps = expected_routes(model, (0, 0), decoder_routes(cfg, 16, 16))
    print(f"{label} counters: admission of 16 prompts {lengths} tokens long: "
          f"{show_routes(admitted, want)}; 16 decode steps at M=16: "
          f"{show_routes(stepped, want_steps)}; peak device memory since load_{bits}bit "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    if admitted != want or stepped != want_steps:
        raise AssertionError(f"the int{bits} batch did not go through the kernels as counted")
    return logits


# -- speculative decoding (--lookahead) -------------------------------------------------

SPEC_LOOKAHEAD = 4
# Questions that repeat themselves, so that prompt lookup finds n-grams to copy.
SPEC_QUESTIONS = ("what is the man with the red hat doing and what is the man with the red hat "
                  "holding", "count the cars on the street and say which of the cars on the "
                  "street is the largest of the cars")


def first_divergence(a, b) -> int:
    """How many leading tokens two streams share."""
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def run_spec_dense(model, cfg, seed: int, max_new_tokens: int, card: str) -> dict:
    """The dense path with `lookahead` 4 and 0 in one call: two /chat requests
    each (two sessions, one anyres image each) through the port's server.
    Exact counts: K1 once per layer per request; K2 once per layer per verify
    call (lookahead 4) or per decode step (lookahead 0). Prints how far the
    two streams agree (bf16: a verify's S-row append and a decode step round
    differently, so greedy ties may break apart), proposals and acceptance,
    tokens per verify call, TTFT and tokens/s."""
    import numpy as np

    from vis_zephyr_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import generate as gen
    from vis_zephyr_tpu_torch.serve.engine import ChatEngine

    L = cfg.decoder.num_layers
    side = cfg.vision.image_size
    rng = np.random.default_rng(seed + 3)
    images = [session_pixels(rng, side, 3) for _ in SPEC_QUESTIONS]
    out = {}
    for lookahead in (SPEC_LOOKAHEAD, 0):
        engine = ChatEngine(model, cfg, WordTokenizer(cfg.decoder.vocab_size),
                            max_new_tokens=max_new_tokens, lookahead=lookahead)
        for i, (px, valid) in enumerate(images):
            engine.attach_pixels(f"d{i}", px, valid, (2 * side, side))
        server, thread = start_server(engine)
        try:
            fa.launches = kv_cache.launches = 0
            gen.verify_calls = gen.proposed = gen.accepted = 0
            results = [post_chat(server.server_address[1], {
                "session_id": f"d{i}", "question": f"{DEFAULT_IMAGE_TOKEN}\n{q}"})
                for i, q in enumerate(SPEC_QUESTIONS)]
            counts = dict(k1=fa.launches, k2=kv_cache.launches, verify_calls=gen.verify_calls,
                          proposed=gen.proposed, accepted=gen.accepted)
        finally:
            stop_server(server, thread)
        streams = []
        for status, text, ttft, total in results:
            words = text.split()
            if status != 200 or len(words) != max_new_tokens:
                raise AssertionError(f"spec dense, lookahead {lookahead}: HTTP {status}, "
                                     f"{len(words)} tokens (want {max_new_tokens})")
            streams.append([int(w[1:]) for w in words])
        n = len(results)
        decode = n * (max_new_tokens - 1)
        passes = counts["verify_calls"] if lookahead else decode
        if counts["k1"] != L * n or counts["k2"] != L * passes or (lookahead and passes == 0):
            raise AssertionError(f"spec dense, lookahead {lookahead}: counts {counts} (want K1 "
                                 f"{L * n}, K2 {L} x {passes} decoder passes, verify calls > 0)")
        ttfts = [r[2] for r in results]
        rates = [(max_new_tokens - 1) / (r[3] - r[2]) for r in results]
        line = (f"spec dense, lookahead {lookahead}: {n} requests, {max_new_tokens} tokens each; "
                f"K1 {counts['k1']} (want {L * n}), K2 {counts['k2']} (want {L} x {passes} "
                f"{'verify calls' if lookahead else 'decode steps'}); TTFT "
                f"{', '.join(f'{t * 1e3:.1f}' for t in ttfts)} ms, decode "
                f"{', '.join(f'{r:.2f}' for r in rates)} tokens/s")
        if lookahead:
            line += (f"; {counts['proposed']} tokens proposed, {counts['accepted']} accepted, "
                     f"{decode / passes:.3f} tokens per verify call")
        print(line + f" [{card}]")
        out[lookahead] = dict(counts, streams=streams, ttft=ttfts, rates=rates)
    agree = [first_divergence(a, b) for a, b in zip(out[SPEC_LOOKAHEAD]["streams"], out[0]["streams"])]
    print(f"spec dense: the lookahead {SPEC_LOOKAHEAD} and lookahead 0 streams agree on their first "
          f"{agree} of {max_new_tokens} tokens")
    return {"k1": out[SPEC_LOOKAHEAD]["k1"], "k2": out[SPEC_LOOKAHEAD]["k2"],
            "agree": agree, **{k: out[SPEC_LOOKAHEAD][k] for k in ("verify_calls", "proposed",
                                                                   "accepted")}}


def fixed_proposals(b, S: int) -> torch.Tensor:
    """toks [B, S]: each slot's pending token, then the S - 1 tokens that
    followed an earlier occurrence of it in the slot's prompt (prompt lookup
    on one token; the prompt's own next tokens when it has none)."""
    import numpy as np

    toks = np.zeros((b.max_slots, S), np.int64)
    for slot in range(b.max_slots):
        hist = np.asarray(b.slot_hist[slot])
        hits = np.flatnonzero(hist[:-1] == hist[-1])
        start = int(hits[-1]) + 1 if len(hits) else 0
        cont = hist[start:start + S - 1]
        toks[slot, 0] = hist[-1]
        toks[slot, 1:1 + len(cont)] = cont
    return torch.as_tensor(toks, device=b.device)


def run_spec_batch(model, cfg, seed: int) -> dict:
    """One verify step (S = 5, fixed proposals) of 16 slots admitted whole, on
    clones of the pools, over int8 fused and bf16 split pools: the kernel
    path against the plain path (cosine >= 0.999 on every column), and column
    0 against `_paged_step`'s logits from the same pool state (>= 0.999 over
    bf16 pools; >= 0.99 over int8, where the verify attends its own row
    quantized and the decode step folds it in unquantized). Counts exact: K3
    and K4's `paged_kv_update_layer` once per layer, no all-layer write."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve.paged import _paged_step, _paged_verify_body

    L = cfg.decoder.num_layers
    S = SPEC_LOOKAHEAD + 1
    requests = direct_requests(cfg, seed, 16)
    out = {}
    for quant, fused, label, floor in ((True, True, "int8 fused", 0.99),
                                       (False, False, "bf16 split", 0.999)):
        b = admitted_batcher(model, cfg, requests, 16, kv_quant=quant, kv_fused=fused)
        toks = fixed_proposals(b, S)
        active = torch.ones(16, dtype=torch.bool, device=b.device)

        def pools():
            return [None if t is None else t.clone() for t in (b.kp, b.vp, b.ksp, b.vsp)]

        kp, vp, ksp, vsp = pools()
        pa.attn_launches = pa.rows_launches = pa.update_launches = 0
        _, logits_k = _paged_verify_body(model, kp, vp, (ksp, vsp), b.page_table,
                                         b.lengths.clone(), toks, active, cfg)
        counts = (pa.attn_launches, pa.rows_launches, pa.update_launches)
        kp, vp, ksp, vsp = pools()
        with _kernels.plain_versions():
            _, logits_p = _paged_verify_body(model, kp, vp, (ksp, vsp), b.page_table,
                                             b.lengths.clone(), toks, active, cfg)
        kp, vp, ksp, vsp = pools()
        _, logits_d = _paged_step(model, kp, vp, (ksp, vsp), b.page_table, b.lengths.clone(),
                                  toks[:, 0].clone(), active, None, cfg, b.sampling)
        torch.cuda.synchronize()
        cols = [float(slot_cosines(logits_k[:, j], logits_p[:, j]).min()) for j in range(S)]
        col0 = slot_cosines(logits_k[:, 0], logits_d)
        same_top1 = float((logits_k[:, 0].argmax(-1) == logits_d.argmax(-1)).float().mean())
        print(f"spec batch, {label} pools, 16 slots, one verify step of S={S}: logits cosine, "
              f"minimum over slots, kernel vs plain path per column "
              f"{', '.join(f'{c:.6f}' for c in cols)} (>= 0.999); column 0 vs the decode step "
              f"min {float(col0.min()):.6f} median {float(col0.median()):.6f} (>= {floor}), same "
              f"top-1 on {same_top1:.3f} of slots; launches K3 {counts[0]} (want {L}), "
              f"paged_kv_rows {counts[1]} (want 0), paged_kv_update {counts[2]} (want {L})")
        if not (min(cols) >= 0.999 and float(col0.min()) >= floor
                and bool(torch.isfinite(logits_k).all()) and counts == (L, 0, L)):
            raise AssertionError(f"spec batch {label}: the verify step disagrees or miscounted")
        out[label] = dict(cols=cols, col0=float(col0.min()))
        del b, kp, vp, ksp, vsp, logits_k, logits_p, logits_d
        torch.cuda.empty_cache()
    return out


VERIFY_STEPS = 5  # consecutive verify steps compared: the capture's warm-up, then replays


def run_verify_replay(model, cfg, seed: int, card: str) -> dict:
    """The verify steps of both served paths replayed as CUDA graphs against
    the same steps run eagerly on the kernel path, bit for bit, over
    VERIFY_STEPS consecutive steps (the first the capture's warm-up, the
    rest replays) with the host's acceptance and rollback between them;
    then each form's wall, device busy and idle share (printed, not gated),
    the captures' host time and the graph pools' memory.

    Paged: two batchers of 32 slots (int8 KV-fused pools, S = 5), the second
    given the first's admitted state; the first steps as served
    (`PagedBatcher.step`, its verify step a replay over `verify_buffers`),
    the second through `_paged_verify_body` run eagerly; after each step the
    logits, pools, lengths, pending tokens and the host's streams equal; K3
    and K4 32 launches a step on each, no all-layer write. Dense: a
    repetitive text prompt prefilled into two caches; `verify_step`
    (replays over the first) against `decode_verify` on the second, with the
    same prompt-lookup proposals and rollback: greedy tokens, logits, K, V
    and lengths equal after each step; K2 32 launches and one verify call a
    step on each."""
    import numpy as np

    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve import generate as gen
    from vis_zephyr_tpu_torch.serve.graphs import StepGraphs
    from vis_zephyr_tpu_torch.serve.paged import _paged_verify_body

    L = cfg.decoder.num_layers
    S = SPEC_LOOKAHEAD + 1
    out = {}
    requests = direct_requests(cfg, seed, 32)
    extra = dict(lookahead=SPEC_LOOKAHEAD, max_new_tokens=512, num_pages=1 + 32 * 16)
    served = admitted_batcher(model, cfg, requests, 32, kv_quant=True, kv_fused=True, **extra)
    eager = admitted_batcher(model, cfg, requests, 32, kv_quant=True, kv_fused=True, **extra)

    def device_state(b):
        return [t for t in (b.kp, b.vp, b.ksp, b.vsp, b.page_table, b.lengths, b.token)
                if t is not None]

    for mine, theirs in zip(device_state(eager), device_state(served)):
        mine.copy_(theirs)  # the same start, whatever the two admissions rounded

    def eager_verify(toks, valid):
        toks_dev, active_dev = eager.verify_buffers(S)
        toks_dev.copy_(torch.from_numpy(toks))
        active_dev.copy_(torch.from_numpy(eager.active))
        greedy, eager.last_logits = _paged_verify_body(
            model, eager.kp, eager.vp, (eager.ksp, eager.vsp), eager.page_table, eager.lengths,
            toks_dev, active_dev, cfg)
        return greedy.cpu().numpy()

    eager._verify_device = eager_verify
    pa.attn_launches = pa.rows_launches = pa.update_launches = 0
    steps = []
    for _ in range(VERIFY_STEPS):
        served.step()
        eager.step()
        steps.append(dict(
            logits=torch.equal(served.last_logits, eager.last_logits),
            device=all(torch.equal(x, y) for x, y in zip(device_state(served),
                                                          device_state(eager))),
            host=(served.slot_len.tolist() == eager.slot_len.tolist()
                  and [list(h) for h in served.slot_hist] == [list(h) for h in eager.slot_hist])))
    counts = (pa.attn_launches, pa.rows_launches, pa.update_launches)
    want = (2 * L * VERIFY_STEPS, 0, 2 * L * VERIFY_STEPS)
    equal = {key: all(step[key] for step in steps) for key in ("logits", "device", "host")}
    print(f"spec verify replay, paged: 32 slots, int8 fused pools, S={S}: {VERIFY_STEPS} verify "
          f"steps as served (the first the capture's warm-up, then replays) against "
          f"{VERIFY_STEPS} eager kernel-path steps from the same state, acceptance and rollback "
          f"between them: bit-equal {equal} (logits, pools, page table, lengths and pending "
          f"tokens; the host's streams); {served.accepted} of {served.proposed} proposals "
          f"accepted; K3 {counts[0]}, paged_kv_rows {counts[1]}, paged_kv_update {counts[2]} "
          f"(want {want}); capture {served.graphs.capture_seconds:.2f} s of host time, graph "
          f"pools {served.graphs.pool_bytes() / 2**20:.1f} MiB (the decode step's none: no "
          f"decode step ran) [{card}]", flush=True)
    if not all(equal.values()) or counts != want:
        raise AssertionError(f"spec verify replay, paged: the replayed verify step disagrees with "
                             f"the eager one or miscounted: {steps}, {counts}")
    for name, b in (("replayed", served), ("eager", eager)):
        got = profile_step(b.step, warm=2, timed=8, profiled=4)
        out[f"paged_{name}"] = {k: v for k, v in got.items() if k != "items"}
        print(f"spec verify replay, paged, {name} verify step, B=32, S={S}: wall "
              f"{got['wall_ms']:.2f} ms (min {got['wall_min_ms']:.2f}, max {got['wall_max_ms']:.2f}),"
              f" device busy {got['device_ms']:.2f} ms, idle share {got['idle_share']:.2f}, "
              f"{got['launches']:.1f} kernel launches a step [{card}]", flush=True)
        if int(b.active.sum()) != 32:
            raise AssertionError("spec verify replay: a slot finished inside the timed steps")
    out["paged_pool_mib"] = served.graphs.pool_bytes() / 2**20
    del served, eager
    torch.cuda.empty_cache()

    # The serialized path: B = 1 over a dense cache.
    rng = np.random.default_rng(seed + 6)
    ids = np.tile(rng.integers(3, cfg.decoder.vocab_size, (1, 12)), (1, 8))
    ids_t = torch.from_numpy(ids).cuda()
    last, cache, _ = gen.prefill(model, ids_t, None, None, cfg, 512)
    other = {name: t.clone() for name, t in cache.items()}
    graphs = StepGraphs()
    history, tok = ids[0].tolist(), int(last.argmax(-1)[0])
    kv_cache.launches = gen.verify_calls = 0
    dense_steps, accepted = [], 0
    for _ in range(VERIFY_STEPS):
        prop = gen._propose_lookup(np.asarray(history), span=SPEC_LOOKAHEAD)
        prop = np.zeros((0,), np.int64) if prop is None else np.asarray(prop, np.int64)
        toks = np.zeros((1, S), np.int64)
        toks[0, 0], toks[0, 1:1 + len(prop)] = tok, prop
        valid = np.zeros((1, S), bool)
        valid[0, :1 + len(prop)] = True
        base = cache["length"].clone()
        greedy_r, logits_r = gen.verify_step(model, cache, torch.from_numpy(toks),
                                             torch.from_numpy(valid), cfg, graphs)
        logits_e, _ = gen.decode_verify(model, other, torch.from_numpy(toks).cuda(),
                                        torch.from_numpy(valid).cuda(), cfg)
        greedy_e = torch.argmax(logits_e, dim=-1)
        greedy = greedy_r[0].tolist()
        n_ok = 0
        while n_ok < len(prop) and greedy[n_ok] == prop[n_ok]:
            n_ok += 1
        accepted += n_ok
        check = dict(greedy=torch.equal(greedy_r, greedy_e), logits=torch.equal(logits_r, logits_e))
        cache["length"].copy_(base + 1 + n_ok)
        other["length"].copy_(base + 1 + n_ok)
        check.update({name: torch.equal(cache[name], other[name]) for name in ("k", "v", "length")})
        dense_steps.append(check)
        emitted = [int(t) for t in prop[:n_ok]] + [greedy[n_ok]]
        history += emitted
        tok = emitted[-1]
    dense_counts = (kv_cache.launches, gen.verify_calls)
    dense_want = (2 * L * VERIFY_STEPS, 2 * VERIFY_STEPS)
    dense_equal = {key: all(step[key] for step in dense_steps) for key in dense_steps[0]}
    print(f"spec verify replay, dense: B=1, a repetitive prompt of {ids.shape[1]} tokens, "
          f"S={S}: {VERIFY_STEPS} verify steps (`verify_step`: the warm-up, then replays) against "
          f"{VERIFY_STEPS} eager `decode_verify`s with the same proposals and rollback: bit-equal "
          f"{dense_equal}; {accepted} proposals accepted; K2 {dense_counts[0]}, verify calls "
          f"{dense_counts[1]} (want {dense_want}); capture {graphs.capture_seconds:.2f} s, graph "
          f"pool {graphs.pool_bytes() / 2**20:.1f} MiB [{card}]", flush=True)
    if not all(dense_equal.values()) or dense_counts != dense_want:
        raise AssertionError(f"spec verify replay, dense: the replayed verify step disagrees "
                             f"with the eager one or miscounted: {dense_steps}, {dense_counts}")
    toks_t = torch.from_numpy(toks)
    valid_t = torch.from_numpy(valid)

    def replayed():
        base = cache["length"].clone()
        gen.verify_step(model, cache, toks_t, valid_t, cfg, graphs)[0].tolist()
        cache["length"].copy_(base)

    def eager_step():
        base = other["length"].clone()
        logits, _ = gen.decode_verify(model, other, toks_t.cuda(), valid_t.cuda(), cfg)
        torch.argmax(logits, dim=-1).tolist()
        other["length"].copy_(base)

    for name, step in (("replayed", replayed), ("eager", eager_step)):
        got = profile_step(step, warm=2, timed=8, profiled=4)
        out[f"dense_{name}"] = {k: v for k, v in got.items() if k != "items"}
        print(f"spec verify replay, dense, {name} verify step, B=1, S={S}: wall "
              f"{got['wall_ms']:.2f} ms (min {got['wall_min_ms']:.2f}, max {got['wall_max_ms']:.2f}),"
              f" device busy {got['device_ms']:.2f} ms, idle share {got['idle_share']:.2f}, "
              f"{got['launches']:.1f} kernel launches a step [{card}]", flush=True)
    del cache, other, graphs
    torch.cuda.empty_cache()
    return out


# -- multi-step bursts (--multi-step) ------------------------------------------------------

BURST_STEPS = 8             # the fixed batch's compared steps, and the served bursts' size
BURST_SIZES = (1, 4, 8, 16)  # the timed bursts


def first_differences(a: torch.Tensor, b: torch.Tensor) -> dict:
    """{slot: first step where toks a and b [n, B] differ}."""
    diff = (a != b).cpu()
    return {slot: int(torch.nonzero(diff[:, slot])[0, 0]) + 1
            for slot in range(diff.shape[1]) if bool(diff[:, slot].any())}


def run_burst_batch(model, cfg, seed: int, card: str) -> dict:
    """A fixed batch of 32 slots (int8 KV-fused pools, the profile's shape):
    eight graph-replayed steps (`_paged_multi_step` bursts of one, the graph
    captured first and the state put back in place) against eight eager
    `_paged_step`s on the kernel path, on clones of its state: tokens equal
    on every slot at every step and logits cosine >= 0.999 per slot per step
    (a slot whose token differs is printed with its step and compared no
    further; any such slot fails the phase); K3 and K4 counted exactly, a
    replay as a launch. Then a burst of 8 (graphs) against the same burst
    under `plain_versions()` (eager, plain kernels): each slot's first
    differing token printed (bf16 ties between two arithmetic orders),
    logits cosine >= 0.999 at the last step on the slots that never
    differed, at least half of the slots without a difference."""
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa
    from vis_zephyr_tpu_torch.serve.graphs import StepGraphs
    from vis_zephyr_tpu_torch.serve.paged import _paged_multi_step, _paged_step

    L = cfg.decoder.num_layers
    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True)
    active = torch.ones(32, dtype=torch.bool, device=b.device)
    left = torch.full((32,), 64, dtype=torch.int32, device=b.device)
    admitted = [b.kp, b.vp, b.ksp, b.vsp, b.lengths, b.token]

    def clone():
        return [None if t is None else t.clone() for t in admitted]

    def burst(state, n, graphs):
        kp, vp, ksp, vsp, lengths, token = state
        return _paged_multi_step(model, kp, vp, (ksp, vsp), b.page_table, lengths, token, active,
                                 left, None, cfg, b.sampling, n=n, graphs=graphs)

    graphed, eager, graphs = clone(), clone(), StepGraphs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    burst(graphed, 1, graphs)  # the warm-up step, then the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    for t, a in zip(graphed, admitted):
        if t is not None:
            t.copy_(a)  # in place: the graph keeps reading these buffers
    before = (pa.attn_launches, pa.rows_launches)
    diverged, cos_min = {}, 1.0
    for step in range(1, BURST_STEPS + 1):
        toks, _, logits_g = burst(graphed, 1, graphs)
        kp, vp, ksp, vsp, lengths, token = eager
        tok_e, logits_e = _paged_step(model, kp, vp, (ksp, vsp), b.page_table, lengths, token,
                                      active, None, cfg, b.sampling)
        cos = slot_cosines(logits_g, logits_e).tolist()
        same = (toks[0] == tok_e).tolist()
        for slot in range(32):
            if slot in diverged:
                continue
            cos_min = min(cos_min, cos[slot])
            if not same[slot]:
                diverged[slot] = step
                print(f"multistep batch: slot {slot} differs at step {step}: graph token "
                      f"{int(toks[0, slot])}, eager {int(tok_e[slot])}, logits cosine "
                      f"{cos[slot]:.6f}")
    counted = (pa.attn_launches - before[0], pa.rows_launches - before[1])
    want = (2 * BURST_STEPS * L, 2 * BURST_STEPS)
    same_pools = all(torch.equal(g, e) for g, e in zip(graphed, eager) if g is not None)
    same_lengths = torch.equal(graphed[4], eager[4])
    print(f"multistep batch: 32 slots, lengths about {int(b.slot_len.mean())}, int8 fused pools: "
          f"{BURST_STEPS} graph-replayed steps against {BURST_STEPS} eager kernel-path steps: tokens "
          f"equal on {32 - len(diverged)} of 32 slots at every step, logits cosine min "
          f"{cos_min:.6f} (>= 0.999); lengths equal {same_lengths}, pools and scales bit-equal "
          f"{same_pools}; K3 {counted[0]} and K4 {counted[1]} launches (want {want[0]} and "
          f"{want[1]}: the replays' and the eager steps'); warm-up step and capture "
          f"{capture_s:.2f} s, graph pool {graphs.pool_bytes() / 2**20:.1f} MiB [{card}]")
    if diverged or not cos_min >= 0.999 or not same_lengths or counted != want:
        raise AssertionError("multistep batch: the replayed step disagrees with the eager step")

    # A burst of 8 on graphs against 8 eager kernel-path steps with the carry
    # kept on the host, budgets of 1 to 9 and an EOS falling inside the burst.
    probe = clone()
    for _ in range(3):
        tok3, _ = _paged_step(model, *probe[:2], tuple(probe[2:4]), b.page_table, probe[4],
                              probe[5], active, None, cfg, b.sampling)
    sampling = dataclasses.replace(b.sampling, eos_token_id=int(tok3[5]))
    budgets = torch.tensor([1 + slot % 9 for slot in range(32)], dtype=torch.int32,
                           device=b.device)
    graphed, eager = clone(), clone()
    before = (pa.attn_launches, pa.rows_launches)
    kp, vp, ksp, vsp, lengths, token = graphed
    toks_g, entry_g, logits_g = _paged_multi_step(
        model, kp, vp, (ksp, vsp), b.page_table, lengths, token, active, budgets, None, cfg,
        sampling, n=BURST_STEPS, graphs=StepGraphs())
    kp, vp, ksp, vsp, lengths, token = eager
    alive, left, want_toks, want_entry = active.clone(), budgets.clone(), [], []
    for _ in range(BURST_STEPS):
        want_entry.append(alive.clone())
        tok, logits_e = _paged_step(model, kp, vp, (ksp, vsp), b.page_table, lengths, token,
                                    alive, None, cfg, sampling)
        want_toks.append(tok.clone())
        left -= 1
        alive = alive & (tok != sampling.eos_token_id) & (left > 0)
    counted_burst = (pa.attn_launches - before[0], pa.rows_launches - before[1])
    checks = dict(tokens=torch.equal(toks_g, torch.stack(want_toks)),
                  entry_alive=torch.equal(entry_g, torch.stack(want_entry)),
                  lengths=torch.equal(graphed[4], eager[4]),
                  pools=all(torch.equal(g, e) for g, e in zip(graphed, eager) if g is not None),
                  counts=counted_burst == want)
    ended = int((~alive).sum())
    print(f"multistep batch: a burst of {BURST_STEPS} on graphs (the warm-up step, then "
          f"{BURST_STEPS - 1} replays) against {BURST_STEPS} eager kernel-path steps with the "
          f"carry on the host, budgets 1 to 9 and EOS {sampling.eos_token_id}: {ended} of 32 "
          f"slots ended inside it; equal {checks}; last logits bit-equal "
          f"{torch.equal(logits_g, logits_e)}, max abs difference "
          f"{float((logits_g - logits_e).abs().max()):.3g} [{card}]")
    if not all(checks.values()):
        raise AssertionError("multistep batch: the graph burst's carry disagrees with the eager "
                             f"steps: {checks}")

    kern, plain = clone(), clone()
    toks_k, alive_k, logits_k = burst(kern, BURST_STEPS, StepGraphs())
    with _kernels.plain_versions():
        toks_p, alive_p, logits_p = burst(plain, BURST_STEPS, None)
    firsts = first_differences(toks_k, toks_p)
    kept = [slot for slot in range(32) if slot not in firsts]
    cos = slot_cosines(logits_k, logits_p)[kept] if kept else torch.zeros(1)
    print(f"multistep batch: a burst of {BURST_STEPS} (graph replays) against the same burst under "
          f"plain_versions(): {len(kept)} of 32 slots equal at every step; the others' first "
          f"different step {firsts}; last-step logits cosine on the equal slots min "
          f"{float(cos.min()):.6f} (>= 0.999); alive masks equal {torch.equal(alive_k, alive_p)}")
    if len(kept) < 16 or not float(cos.min()) >= 0.999 or not torch.equal(alive_k, alive_p):
        raise AssertionError("multistep batch: the graph burst disagrees with the plain burst")
    del b, graphed, eager, probe, kern, plain, graphs
    torch.cuda.empty_cache()
    return {"k3": counted[0], "k4": counted[1], "capture_s": capture_s}


def run_burst_dense(model, cfg, seed: int, max_new_tokens: int, card: str) -> dict:
    """The B = 1 dense step replayed against the eager `decode_step` on the
    kernel path, bit for bit: a text prompt prefilled once, a burst of 1
    (the warm-up step and the capture) and a burst of 8 replays on the
    cache, 9 eager steps on a clone of it; tokens, K, V and lengths equal.
    Then two dense /chat requests through the server started with
    `--multi-step 8`, and the same two with `--multi-step 1` (bursts of
    one): K1 once a layer a request, K2 once a layer a decode step (every
    step of a burst counted), exactly, and the two runs' streams equal."""
    import numpy as np

    from vis_zephyr_tpu_torch.constants import DEFAULT_IMAGE_TOKEN
    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.ops import kv_cache
    from vis_zephyr_tpu_torch.serve import api
    from vis_zephyr_tpu_torch.serve.generate import (SamplingConfig, decode_multi_step,
                                                     decode_step, prefill)
    from vis_zephyr_tpu_torch.serve.graphs import StepGraphs

    L = cfg.decoder.num_layers
    ids = torch.randint(3, cfg.decoder.vocab_size, (1, 170),
                        generator=torch.Generator().manual_seed(seed + 5)).cuda()
    last, cache, _ = prefill(model, ids, None, None, cfg, 512)
    eager = {name: t.clone() for name, t in cache.items()}
    token, graphs, sampling = last.argmax(-1), StepGraphs(), SamplingConfig(eos_token_id=-1)
    got, tok = [], token
    for n in (1, BURST_STEPS):
        toks, _, tok = decode_multi_step(model, cache, tok, None, cfg, sampling, n, graphs)
        got.append(toks)
    want = []
    for _ in range(1 + BURST_STEPS):
        logits, eager = decode_step(model, eager, token, cfg)
        token = logits.argmax(-1)
        want.append(token)
    checks = dict(tokens=torch.equal(torch.cat(got), torch.stack(want)),
                  **{name: torch.equal(cache[name], eager[name]) for name in ("k", "v", "length")})
    print(f"multistep dense: a burst of 1 and a burst of {BURST_STEPS} on graphs ({BURST_STEPS} "
          f"replays after the warm-up step) against {1 + BURST_STEPS} eager decode steps, B=1 "
          f"from position 170: bit-equal {checks} [{card}]")
    if not all(checks.values()):
        raise AssertionError(f"multistep dense: the replayed step disagrees with the eager step: "
                             f"{checks}")
    del cache, eager, graphs
    side = cfg.vision.image_size
    rng = np.random.default_rng(seed + 4)
    images = [session_pixels(rng, side, 3) for _ in range(2)]
    questions = ("describe the picture in detail", "what is happening on the street")
    out = {}
    for multi_step in (BURST_STEPS, 1):
        parser = argparse.ArgumentParser()
        api.add_engine_args(parser)
        flags = parser.parse_args(["--max-new-tokens", str(max_new_tokens),
                                   "--multi-step", str(multi_step)])
        engine = api.engine_from_args(model, cfg, WordTokenizer(cfg.decoder.vocab_size), flags)
        for i, (px, valid) in enumerate(images):
            engine.attach_pixels(f"m{i}", px, valid, (2 * side, side))
        server, thread = start_server(engine)
        try:
            fa.launches = kv_cache.launches = 0
            results = [post_chat(server.server_address[1], {
                "session_id": f"m{i}", "question": f"{DEFAULT_IMAGE_TOKEN}\n{q}"})
                for i, q in enumerate(questions)]
            counts = dict(k1=fa.launches, k2=kv_cache.launches)
        finally:
            stop_server(server, thread)
        streams = []
        for status, text, ttft, total in results:
            words = text.split()
            if status != 200 or len(words) != max_new_tokens:
                raise AssertionError(f"multistep dense, --multi-step {multi_step}: HTTP {status}, "
                                     f"{len(words)} tokens (want {max_new_tokens})")
            streams.append([int(w[1:]) for w in words])
        want = (L * len(results), L * len(results) * (max_new_tokens - 1))
        rates = [(max_new_tokens - 1) / (r[3] - r[2]) for r in results]
        print(f"multistep dense, --multi-step {multi_step}: {len(results)} requests of "
              f"{max_new_tokens} tokens; K1 {counts['k1']} (want {want[0]}), K2 {counts['k2']} "
              f"(want {L} x {len(results) * (max_new_tokens - 1)} decode steps = {want[1]}); TTFT "
              f"{', '.join(f'{r[2] * 1e3:.1f}' for r in results)} ms, decode "
              f"{', '.join(f'{r:.2f}' for r in rates)} tokens/s [{card}]")
        if (counts["k1"], counts["k2"]) != want:
            raise AssertionError(f"multistep dense, --multi-step {multi_step}: counts {counts}")
        out[multi_step] = dict(counts, streams=streams)
    agree = [first_divergence(a, b) for a, b in zip(out[BURST_STEPS]["streams"], out[1]["streams"])]
    print(f"multistep dense: the --multi-step {BURST_STEPS} and --multi-step 1 streams agree on "
          f"their first {agree} of {max_new_tokens} tokens (want all)")
    if out[BURST_STEPS]["streams"] != out[1]["streams"]:
        raise AssertionError("multistep dense: the --multi-step 8 and 1 streams differ")
    return {"k1": out[BURST_STEPS]["k1"], "k2": out[BURST_STEPS]["k2"], "agree": agree}


def run_burst_timing(model, cfg, seed: int, card: str, label: str = "multistep",
                     sizes=BURST_SIZES, dense: bool = True) -> dict:
    """Wall per token of the 32-slot paged step (int8 KV-fused pools) run
    eagerly (`_paged_step`, the CPU's and `plain_versions()`'s form, which
    the batcher served before its steps were replayed) and in bursts of
    each of `sizes` (the batcher's `_step_burst`, which ends in the burst's
    one copy to the host), and, with `dense`, of the B = 1 dense step the
    same way (the eager `decode_step`; `decode_multi_step` over the model's
    burst cache); device busy and idle share (torch.profiler, as
    `run_profile` reads a step) of the eager step and of the burst of
    BURST_STEPS; the captures' host seconds and their graph pools' memory.
    Printed, not gated."""
    from vis_zephyr_tpu_torch.experiments import step_profile as sp

    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True, max_new_tokens=512, num_pages=1 + 32 * 16)
    rows = {}
    runs = [("paged", 1, False)] + [("paged", n, True) for n in sizes]
    if dense:
        runs += [("dense", 1, False)] + [("dense", n, True) for n in sizes]
    graphs = {"paged": b.graphs}
    for path, n, in_burst in runs:
        if path == "paged":
            # The batcher's burst at n (a burst of one too), or the eager step.
            step = functools.partial(b._step_burst, n) if in_burst else sp.paged_eager_step(b)
        elif in_burst:
            step, graphs["dense"] = sp.dense_burst(model, cfg, seed, n)
        else:
            step, _ = sp.dense_decode(model, cfg, seed)
        profiled = 0 if in_burst and n != BURST_STEPS else 2 if in_burst else 4
        counts = dict(warm=1, timed=4) if in_burst and n > 1 else dict(warm=2, timed=8)
        got = sp.profile_step(step, per_call=n if in_burst else 1, profiled=profiled, **counts)
        name = f"{path} burst of {n}" if in_burst else f"{path} eager single step"
        rows[(path, n if in_burst else 0)] = got
        device = (f", device busy {got['device_ms']:.2f} ms per token, idle share "
                  f"{got['idle_share']:.2f}, {got['launches']:.1f} kernel launches per token"
                  if profiled else "")
        print(f"{label}: {name}{', B=32' if path == 'paged' else ', B=1'}: wall "
              f"{got['wall_ms']:.2f} ms per token (min {got['wall_min_ms']:.2f}, max "
              f"{got['wall_max_ms']:.2f}){device} [{card}]", flush=True)
        if profiled and got["device_ms"] <= 0:
            print(f"{label}: the profiler reported no device time for {name}")
    if int(b.active.sum()) != 32:
        raise AssertionError(f"{label}: a slot finished inside the timed steps")
    for path, g in graphs.items():
        if g is None:  # the dense step on the CPU runs eagerly
            continue
        print(f"{label}: {path} captures {g.captures} in {g.capture_seconds:.2f} s of host time "
              f"(each with its warm-up step), graph pools {g.pool_bytes() / 2**20:.1f} MiB [{card}]")
    del b
    torch.cuda.empty_cache()
    return rows


def run_verify_routes(model, cfg, seed: int, card: str) -> None:
    """Verify steps of 32 slots (S = 5: 160 rows) on quantized weights, as
    served: every decoder projection takes K5 (int8) or K6 (int4) on chunks
    of 128 and 32 rows (`row_chunks`) and none the dequantize route, counted
    exactly over the first step (its warm-up and capture) and the replays
    after it; the first step's wall and the replayed step's wall, device busy
    and idle share (printed, not gated)."""
    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step
    from vis_zephyr_tpu_torch.ops.quant_matmul import row_chunks

    S = SPEC_LOOKAHEAD + 1
    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True, lookahead=SPEC_LOOKAHEAD, max_new_tokens=512,
                         num_pages=1 + 32 * 16)
    torch.cuda.synchronize()
    reset_routes()
    t0 = time.perf_counter()
    if b.step() != 32:
        raise AssertionError("a slot finished early")
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    got = profile_step(b.step, warm=1, timed=8, profiled=4)
    routes = read_routes()
    want = expected_routes(model, (0, 0), decoder_routes(cfg, 32 * S, b.verify_steps))
    bits = weight_bits(model)
    print(f"int{bits} verify step, 32 slots x S={S} = {32 * S} rows (chunks of "
          f"{row_chunks(32 * S)}), {b.verify_steps} steps: {show_routes(routes, want)}; the first "
          f"step (warm-up and capture) {first:.2f} ms of wall; replayed: wall "
          f"{got['wall_ms']:.2f} ms (min {got['wall_min_ms']:.2f}, max {got['wall_max_ms']:.2f}), "
          f"device busy {got['device_ms']:.2f} ms, idle share {got['idle_share']:.2f}, "
          f"{got['launches']:.1f} kernel launches a step [{card}]")
    if routes != want or routes["dequant"] or routes["dequant4"] or int(b.active.sum()) != 32:
        raise AssertionError("the quantized verify step did not route as counted")
    del b
    torch.cuda.empty_cache()


def run_profile(model, cfg, seed: int, card: str, label: str = "profile",
                lookahead: int = 0) -> None:
    """One batched decode step at B=32 (`PagedBatcher.step`: a replayed burst
    of one; a verify step of S = lookahead + 1 rows per slot, replayed too,
    when `lookahead` > 0): wall (host clock around steps that
    end in a synchronize), device-busy time, kernel launches per step and the
    largest device items (torch.profiler kernel sums; one stream, so kernels
    do not overlap)."""
    from vis_zephyr_tpu_torch.experiments.step_profile import profile_step, show_step

    # Verify steps emit up to S tokens a slot: a longer budget (and the pages
    # for it) keeps all 32 slots active through the 28 steps.
    extra = dict(lookahead=lookahead, max_new_tokens=512, num_pages=1 + 32 * 16) if lookahead else {}
    b = admitted_batcher(model, cfg, direct_requests(cfg, seed, 32), 32, kv_quant=True,
                         kv_fused=True, **extra)
    got = profile_step(b.step)
    if int(b.active.sum()) != 32:
        raise AssertionError(f"{label}: a slot finished inside the profiled steps")
    kind = f"verify step (S={lookahead + 1})" if lookahead else "decode step"
    show_step(f"{label}: batched {kind}, B=32 active slots, lengths about "
              f"{int(b.slot_len.mean())}", label, got, card)


def run_dense_profile(model, cfg, seed: int, card: str) -> None:
    """One dense decode step (B = 1, bf16 weights, a text prompt of 170
    tokens) profiled as `run_profile` profiles a batched one; K2 must launch
    once a layer a step."""
    from vis_zephyr_tpu_torch.experiments import step_profile
    from vis_zephyr_tpu_torch.ops import kv_cache

    step, state = step_profile.dense_decode(model, cfg, seed)
    before = kv_cache.launches
    got = step_profile.profile_step(step, warm=4, timed=16, profiled=8)
    k2 = (kv_cache.launches - before) / (4 + 16 + 8)
    step_profile.show_step(f"dense profile: decode step, B=1, position about "
                           f"{int(state['cache']['length'][0])}, K2 {k2:.0f} launches per step",
                           "dense profile", got, card)
    if k2 != cfg.decoder.num_layers:
        raise AssertionError(f"dense profile: {k2} K2 launches per step, expected one per "
                             f"layer ({cfg.decoder.num_layers})")


PREFILL_TOKENS = 2048  # a long text prompt: K1 in each of the 32 layers at T = S = 2048


def run_prefill_profile(model, cfg, seed: int, card: str) -> None:
    """A text-only dense prefill of 2048 tokens on bf16 weights: wall (host
    clock around calls that end in a synchronize, median of 5), device busy,
    idle share, K1's device time and launches, and the largest device items
    (torch.profiler over 2 calls)."""
    from torch.profiler import ProfilerActivity, profile

    from vis_zephyr_tpu_torch.ops import flash_attention as fa
    from vis_zephyr_tpu_torch.serve.generate import prefill

    rng = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, cfg.decoder.vocab_size, (1, PREFILL_TOKENS), generator=rng).cuda()

    def call():
        prefill(model, ids, None, None, cfg, PREFILL_TOKENS + 128)

    call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n = 2
    before = fa.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    launches = (fa.launches - before) / n
    rows, busy = device_items(prof, n)
    k1_ms = sum(ms for key, ms, _ in rows if "flash_fwd_kernel" in key)
    wall = statistics.median(walls)
    share = f"{k1_ms / busy:.1%}" if busy > 0 else "not measured"
    print(f"prefill profile: text-only prefill, T={PREFILL_TOKENS}, bf16 weights: wall median "
          f"{wall:.2f} ms (5 calls, min {min(walls):.2f}, max {max(walls):.2f}), device busy "
          f"{busy:.2f} ms per call, idle share {1 - busy / wall:.2f}; K1 {k1_ms:.3f} ms "
          f"({share} of the device time), {launches:.0f} launches per call [{card}]")
    for key, ms, count in rows[:8]:
        print(f"prefill profile:   {ms:8.3f} ms  {count:6.1f} launches/call  {key[:90]}")
    if busy <= 0:
        print("prefill profile: the profiler reported no device time")
    if launches != cfg.decoder.num_layers:
        raise AssertionError(f"prefill profile: {launches} K1 launches per call, expected one "
                             f"per layer ({cfg.decoder.num_layers})")


# -- training ------------------------------------------------------------------------

TRAIN_BATCH = 8        # bench.py's stage-1 batch
TRAIN_STEPS = 3        # stage-1 optimizer steps through train()
LORA_STEPS = 2         # stage-2 steps through make_train_step
CAPTION_WORDS = 2100   # over 2048 - 4 * 32 text tokens: the splice is truncated at 2048


class CaptionDataset:
    """Stage-1 records in memory for `train(dataset=...)`: `<image>` and a
    caption of CAPTION_WORDS words, through the port's `preprocess` (the
    plain template) and WordTokenizer, with seeded pixels of 4 anyres crops
    in place of an image file (the card's machine has no PIL). Long enough
    that `model_max_length` 2048 truncates the spliced sequence, as
    `bench.py`'s train cell does: only then is the length a multiple of 128
    and the flash kernels run."""

    def __init__(self, tokenizer, n: int, seed: int, side: int = 336, crops: int = 4):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.tokenizer, self.n, self.seed, self.side, self.crops = tokenizer, n, seed, side, crops
        self.captions = [make_question(rng, CAPTION_WORDS) for _ in range(n)]
        self.lengths = [CAPTION_WORDS + 128] * n
        self.modality_lengths = [CAPTION_WORDS] * n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        import numpy as np

        from vis_zephyr_tpu_torch.conversation import templates
        from vis_zephyr_tpu_torch.data.tokenization import preprocess

        turns = [{"from": "human", "value": "<image>\n"}, {"from": "gpt", "value": self.captions[i]}]
        out = preprocess([turns], self.tokenizer, has_image=True, conv=templates["plain"])
        pixels = np.random.default_rng((self.seed, i)).standard_normal(
            (self.crops, self.side, self.side, 3), dtype=np.float32) * 0.5
        return {"input_ids": out["input_ids"][0], "labels": out["labels"][0], "images": pixels,
                "patch_valid": np.ones(self.crops, bool)}


def reset_flash() -> None:
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    fa.launches = fa.bwd_dkv_launches = fa.bwd_dq_launches = 0


def read_flash() -> dict:
    from vis_zephyr_tpu_torch.ops import flash_attention as fa

    return dict(k1=fa.launches, k7=fa.bwd_dkv_launches, k8=fa.bwd_dq_launches)


def expect_flash(got: dict, micro_steps: int, cfg, label: str) -> None:
    """With remat, a micro-step runs K1 twice a layer (forward and recompute)
    and K7 and K8 once a layer."""
    L = cfg.decoder.num_layers
    want = dict(k1=2 * L * micro_steps, k7=L * micro_steps, k8=L * micro_steps)
    print(f"{label}: launches K1 flash_fwd {got['k1']} (want {want['k1']}), K7 flash_bwd_dkv "
          f"{got['k7']} (want {want['k7']}), K8 flash_bwd_dq {got['k8']} (want {want['k8']})")
    if got != want:
        raise AssertionError(f"{label}: flash launch counts {got} != {want}")


def profile_step(step, state, batch, card: str, label: str) -> None:
    """One train step under torch.profiler: its wall (host clock, ending in a
    synchronize), device busy time (kernel sums on one stream), idle share
    and largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def device_us(e):  # the attribute's name changed between PyTorch releases
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    rows = sorted(((e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and device_us(e) > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"{label}: one step under the profiler: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {1 - busy / wall:.3f} [{card}]")
    for key, ms, count in rows[:8]:
        print(f"{label}:   {ms:9.2f} ms  {count:6d} launches  {key[:90]}")
    if busy <= 0:
        print(f"{label}: the profiler reported no device time")


def grad_cosine(xs, ys) -> float:
    """Cosine of two gradient lists taken as one vector each, summed tensor by
    tensor in f64 (a 1.68 B-element f64 copy would not fit beside the model)."""
    dot = na = nb = 0.0
    for a, b in zip(xs, ys):
        a, b = a.double(), b.double()
        dot += float((a * b).sum())
        na += float(a.square().sum())
        nb += float(b.square().sum())
    return dot / math.sqrt(na * nb)


def run_train(seed: int, card: str) -> dict:
    """(a) stage 1 through `train()` at full width, bf16, random weights from
    the seed, TRAIN_STEPS steps of TRAIN_BATCH with remat; (c) one stage-1
    step of 2 rows on the kernel path and on the plain path; (b) stage 2 (LoRA
    r=128, α=256, dropout 0.05) through `make_train_step`, LORA_STEPS steps of
    the same batch shape. Flash launch counts are checked exactly."""
    import os
    import shutil
    import tempfile

    from vis_zephyr_tpu_torch.config import VisZephyrConfig
    from vis_zephyr_tpu_torch.data.dataset import Collator
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.train import train as ttrain
    from vis_zephyr_tpu_torch.train.lora import LoraConfig, add_lora
    from vis_zephyr_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer
    from vis_zephyr_tpu_torch.train.steps import init_train_state, loss_fn, make_train_step

    cfg = VisZephyrConfig()
    T = cfg.tokenizer_model_max_length
    tok = WordTokenizer(cfg.decoder.vocab_size)
    data = CaptionDataset(tok, TRAIN_BATCH * TRAIN_STEPS, seed)
    collate = Collator(pad_token_id=cfg.decoder.pad_token_id, max_length=T)

    def batch_of(indices):
        return {k: torch.from_numpy(v).cuda() for k, v in collate([data[i] for i in indices]).items()}

    # (a) stage 1 through the trainer's entry point; its saves timed.
    out = tempfile.mkdtemp(prefix="vzt_train_")
    saves = []
    real_save = ttrain.save_checkpoint

    def timed_save(output_dir, state, step, projector_only=False, metadata=None):
        t0 = time.perf_counter()
        path = real_save(output_dir, state, step, projector_only=projector_only, metadata=metadata)
        n_bytes = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)
        saves.append(("projector" if projector_only else "full state", time.perf_counter() - t0,
                      n_bytes))
        return path

    args = ttrain.TrainArguments(stage="1", output_dir=out, per_device_batch_size=TRAIN_BATCH,
                                 max_steps=TRAIN_STEPS, save_steps=10 ** 6, logging_steps=1,
                                 remat=True, resume=False, dtype="bfloat16", seed=seed,
                                 model_max_length=T, device="cuda")
    ttrain.save_checkpoint = timed_save
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_flash()
        t0 = time.perf_counter()
        state = ttrain.train(args, tok, cfg=cfg, dataset=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stage1 = read_flash()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        with open(os.path.join(out, "benchmark.csv")) as f:
            bench_csv = f.read().strip().splitlines()[-1]
    finally:
        ttrain.save_checkpoint = real_save
        shutil.rmtree(out, ignore_errors=True)
    if len(rows) != TRAIN_STEPS or not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                                           for r in rows):
        raise AssertionError(f"train stage 1: metrics {rows}")
    for r in rows:
        print(f"train stage 1 (train(), B={TRAIN_BATCH}, T={T}, remat): step {r['step']} loss "
              f"{r['loss']:.4f} grad_norm {r['grad_norm']:.4f} step {r['step_time_s']:.3f} s, "
              f"{TRAIN_BATCH * T / r['step_time_s']:.0f} tokens/s "
              f"({r['tokens'] / r['step_time_s']:.0f} target tokens/s) [{card}]")
    print(f"train stage 1: {wall:.1f} s in train() for {TRAIN_STEPS} steps and the final saves; "
          f"peak torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; benchmark.csv row "
          f"{bench_csv}")
    for kind, seconds, n_bytes in saves:
        print(f"train stage 1: final {kind} save {seconds:.2f} s, {n_bytes / 2**30:.3f} GiB")
    expect_flash(stage1, TRAIN_STEPS, cfg, "train stage 1")

    model = state["params"]
    big = batch_of(range(TRAIN_BATCH))
    # The device's idle share in a stage-1 step (an extra update).
    step = make_train_step(model, cfg, state["opt_state"], remat=True)
    profile_step(step, state, big, card, "train stage 1")

    # (c) one stage-1 step, kernels against their plain versions: the loss
    # and the projector's gradients on the same weights and batch.
    small = batch_of(range(2))
    proj = list(model.projector.parameters())

    def loss_and_grads():
        loss, _ = loss_fn(model, small, cfg, remat=True)
        return float(loss.detach()), torch.autograd.grad(loss, proj)

    reset_flash()
    k_loss, k_grads = loss_and_grads()
    expect_flash(read_flash(), 1, cfg, "train kernel vs plain (B=2), kernel path")
    with _kernels.plain_versions():
        p_loss, p_grads = loss_and_grads()
    rel = abs(k_loss - p_loss) / abs(p_loss)
    cos = grad_cosine(k_grads, p_grads)
    print(f"train kernel vs plain (B=2, stage 1): loss {k_loss:.6f} vs {p_loss:.6f} (relative "
          f"{rel:.2e}, <= 1e-3), projector gradient cosine {cos:.6f} (>= 0.999)")
    if not (rel <= 1e-3 and cos >= 0.999):
        raise AssertionError("train: the kernel path disagrees with the plain path")
    del k_grads, p_grads, state, big, step

    # (b) stage 2: LoRA adapters on the same model through make_train_step.
    gc.collect()
    torch.cuda.empty_cache()
    add_lora(model, LoraConfig(r=128, alpha=256), torch.Generator("cuda").manual_seed(seed + 1))
    opt = build_optimizer(model, OptimizerConfig(total_steps=LORA_STEPS), stage="2")
    n_lora = sum(p.numel() for p in opt.params)
    step = make_train_step(model, cfg, opt, remat=True, lora_dropout=0.05, dropout_seed=seed)
    state = init_train_state(model, opt)
    reset_flash()
    for i in range(LORA_STEPS):
        batch = batch_of(range(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH))
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        seconds = time.perf_counter() - t0
        print(f"train stage 2 (LoRA r=128, alpha=256, dropout 0.05, {n_lora / 1e6:.1f} M adapter "
              f"params, B={TRAIN_BATCH}, T={T}): step {i + 1} loss {loss:.4f} grad_norm "
              f"{norm:.4f} {seconds:.3f} s [{card}]")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError("train stage 2: a non-finite loss or grad_norm")
    stage2 = read_flash()
    expect_flash(stage2, LORA_STEPS, cfg, "train stage 2")
    return {"train": stage1, "train_lora": stage2}


GROUPED_PAIRS = (1, 2, 4, 8)  # slots a block owns: 1 is K10, more K11
GROUPED_PAGES = (1, 5, 6, 8)  # pages_per_block: the probes' timed steps


def grouped_call(pa, case, q, k_new, v_new, pair, ppcb, window=None, **over):
    """K10 (pair 1) or K11 over a `paged_case`'s int8 fused pools, layer 1."""
    c = dict(case, **over)
    args = (q, c["kp"], c["table"], case["lengths"], case["lengths"], k_new, v_new, c["ksc"],
            ppcb, window)
    if pair == 1:
        return pa.paged_attention_batched(*args, page_offset=case["P"])
    return pa.paged_attention_paired(*args, page_offset=case["P"], pair=pair)


def check_grouped(gen) -> dict:
    """K10 and K11 against their plain version and against K3 at B=32, Hq=32,
    Hkv=8, D=128, page 128, 16 pages a slot, int8 fused pools with the
    self-term, lengths that include 0, 1, 128, 129 and 2048: P = 1, 2, 4 and
    8 with `pages_per_block` 1, 5, 6 and 8 (every tiling the probes time),
    with and without a window of 512; per
    slot max-abs error <= 1e-2 of the slot's largest value and cosine >=
    0.9999; the slot of length 0 exactly its v_new; NaN in the scales past
    every slot's length leaves the output unchanged bit for bit. Then
    `paged_attention_fa` with an explicit `slot_block` of 2 (B = 31: one
    empty slot of padding) launches K11 on fused int8 pools and K3 on split
    bf16 ones."""
    from vis_zephyr_tpu_torch.experiments.probe_common import agreement
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    dev = "cuda"
    Hq, Hkv, D, ps, B = 32, 8, 128, 128, 32
    edge = [0, 1, 128, 129, 2048, 2047, 127, 1025]
    lengths = edge + torch.randint(1, 2049, (B - len(edge),), generator=gen, device=dev).tolist()
    case = paged_case(gen, lengths, True, True)
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v_new = torch.randn(B, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    k3 = paged_call(pa, case, q, True, k_new, v_new)
    k3_window = paged_call(pa, case, q, True, k_new, v_new, 512)
    worst = {"k10": 0.0, "k11": 0.0}

    def gate(name, got, want, what):
        a = agreement(got, want, per_slot=True)
        ok = a["rel_err"] <= 1e-2 and a["cosine"] >= 0.9999 and bool(torch.isfinite(got.float()).all())
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with {what} ({a})")
        return a

    for pair in GROUPED_PAIRS:
        name = "K10" if pair == 1 else f"K11 P={pair}"
        for ppcb in GROUPED_PAGES:
            for window in (None, 512):
                got = grouped_call(pa, case, q, k_new, v_new, pair, ppcb, window)
                torch.cuda.synchronize()
                with _kernels.plain_versions():
                    want = grouped_call(pa, case, q, k_new, v_new, pair, ppcb, window)
                label = f"{name}, pages_per_block {ppcb}, window {window}"
                a = gate(label, got, want, "its plain version")
                b = gate(label, got, k3 if window is None else k3_window, "K3")
                key = "k10" if pair == 1 else "k11"
                worst[key] = max(worst[key], float((got.float() - want.float()).abs().max()))
                print(f"{label}: against the plain version per slot {a['rel_err']:.3e} (<= 1e-2), "
                      f"cosine {a['cosine']:.7f}; against K3 {b['rel_err']:.3e}, "
                      f"{b['cosine']:.7f} (>= 0.9999)")
                want0 = v_new[0].repeat_interleave(Hq // Hkv, dim=0)
                if not torch.equal(got[0, 0], want0):
                    raise AssertionError(f"{label}: the slot of length 0 is not its v_new")
        # Whatever a recycled page holds at or past `length` must not reach the
        # output: NaN in the K and V scales there, the same result bit for bit.
        clean = grouped_call(pa, case, q, k_new, v_new, pair, 5)
        dirty_scales = case["ksc"].clone()
        for b, n in enumerate(lengths):
            for j in range(16):
                lo = max(n - j * ps, 0)
                if lo < ps:
                    page = int(case["table"][b, j]) + case["P"]
                    dirty_scales[page, :, lo:ps] = float("nan")
                    dirty_scales[page, :, ps + lo:] = float("nan")
        dirty = grouped_call(pa, case, q, k_new, v_new, pair, 5, ksc=dirty_scales)
        torch.cuda.synchronize()
        same = torch.equal(clean, dirty)
        print(f"{name}: NaN scales past length leave the output unchanged: {same}")
        if not same:
            raise AssertionError(f"{name}: rows past length reached the output")

    # paged_attention_fa with an explicit slot_block: K11 on the probes'
    # configuration (31 slots, padded to 32 by an empty slot), K3 on split bf16.
    def fa(c, **kw):
        return pa.paged_attention_fa(q[:31], c["kp"], c["vp"], c["table"][:31],
                                     c["lengths"][:31], c["lengths"][:31], k_scales=c["ksc"],
                                     v_scales=c["vsc"], k_new=k_new[:31], v_new=v_new[:31],
                                     page_offset=c["P"], **kw)

    split = paged_case(gen, lengths, False, False)
    before = (pa.attn_launches, pa.paired_launches)
    routed = fa(case, slot_block=2, pages_per_block=5)
    counts = (pa.attn_launches - before[0], pa.paired_launches - before[1])
    with _kernels.plain_versions():
        gate("paged_attention_fa(slot_block=2), int8 fused", routed, fa(case, slot_block=2,
             pages_per_block=5), "its plain version")
    before_split = (pa.attn_launches, pa.paired_launches)
    routed_split = fa(split, slot_block=2, pages_per_block=5)
    counts_split = (pa.attn_launches - before_split[0], pa.paired_launches - before_split[1])
    torch.cuda.synchronize()
    if not torch.equal(routed_split, fa(split)):
        raise AssertionError("paged_attention_fa(slot_block=2) on split bf16 pools is not K3's")
    print(f"paged_attention_fa(slot_block=2, pages_per_block=5), 31 slots: int8 fused pools -> "
          f"K3 {counts[0]}, K11 {counts[1]} launches (want 0, 1); split bf16 pools -> K3 "
          f"{counts_split[0]}, K11 {counts_split[1]} (want 1, 0)")
    if counts != (0, 1) or counts_split != (1, 0):
        raise AssertionError("paged_attention_fa's tilings did not route as documented")
    return worst


def time_grouped(seed: int, batched_times: dict, paired_times: dict) -> dict:
    """K10 (pages_per_block 8, the JAX probe's) and K11 (P = 2, pages_per_block
    6, the paired probe's first) at the bench shape, one layer: the timed
    call's output held against the plain version's on the same inputs (per
    slot max-abs error <= 1e-2 of the slot's largest value, cosine >=
    0.9999), CUDA events around one wrapper call (median of 20), the plain
    version, the bound from this run's inputs; the device time a layer from
    the probes' CUDA graphs of 32 layer calls."""
    from vis_zephyr_tpu_torch.experiments import batched_paged_attention_probe as bprobe
    from vis_zephyr_tpu_torch.experiments.probe_common import agreement
    from vis_zephyr_tpu_torch.ops import _kernels
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    c = bprobe.bench_case("cuda", seed + 1, bprobe.BENCH_SLOTS,
                          [bprobe.BENCH_PROMPT] * bprobe.BENCH_SLOTS, 1)
    least, by, _ = bprobe.layer_bound(c)
    args = (c["q"], c["k_pages"], c["page_table"], c["lengths"], c["q_offs"], c["k_new"],
            c["v_new"], c["k_scales"])
    out = {}
    for name, tag, probe, fn in (
            ("paged_attn_batched", "k10_ppcb8", batched_times,
             lambda: pa.paged_attention_batched(*args, 8)),
            ("paged_attn_paired", "k11_P2_ppcb6", paired_times,
             lambda: pa.paged_attention_paired(*args, 6, pair=2))):
        got = fn()
        torch.cuda.synchronize()
        with _kernels.plain_versions():
            a = agreement(got, fn(), per_slot=True)
        print(f"{name} ({tag}) at the bench shape against its plain version: per slot "
              f"{a['rel_err']:.3e} (<= 1e-2), cosine {a['cosine']:.7f} (>= 0.9999)")
        if not (a["rel_err"] <= 1e-2 and a["cosine"] >= 0.9999
                and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"{name} ({tag}) disagrees with its plain version at the bench "
                                 f"shape: {a}")
        ms = median_ms(fn)
        with _kernels.plain_versions():
            plain_ms = median_ms(fn, 5)
        device_ms = probe["B128"]["step_ms"][tag] / probe["B128"]["layers"]
        out[name] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                         bound_ms=least, bound_by=by, config=tag,
                         probe_step_ms={shape: t["step_ms"] for shape, t in probe.items()})
        if name == "paged_attn_paired":
            # K11 and its first design (`walk`) on the device a layer, by P.
            out[name]["device_ms_by_pair"] = {
                shape: {route: ms / t["layers"] for route, ms in t["step_ms"].items()
                        if route.startswith(("k11_", "walk_"))}
                for shape, t in probe.items()}
            for shape, routes in out[name]["device_ms_by_pair"].items():
                print(f"paged_attn_paired on the device a layer at {shape}: "
                      + ", ".join(f"{route} {ms:.4f} ms" for route, ms in routes.items())
                      + f"; bound {probe[shape]['bound_ms_per_layer']:.5f} ms by "
                        f"{probe[shape]['bound_by']}")
        print(f"{name} ({tag}) at the bench shape (128 slots of 640 tokens): {ms:.4f} ms per "
              f"call, {device_ms:.4f} on the device (a layer of the probe's graph); plain "
              f"{plain_ms:.4f} ms; bound {least:.5f} ms by {by}; no library call computes it")
    del c, args
    torch.cuda.empty_cache()
    return out


def run_attn_probes(seed: int, gen, card: str) -> dict:
    """The two attention probes' `main()`, their launches counted from 0
    (numerics, then K3, K10 and K11 in CUDA graphs of 32 layer calls at
    128 slots of 640 tokens and at 32 slots of 60-800), their numerics
    and every timed route's output at both timed shapes gated; then K10
    and K11 held against their plain version and K3
    (`check_grouped`) and timed for the kernels line (`time_grouped`)."""
    from vis_zephyr_tpu_torch.experiments import batched_paged_attention_probe as bprobe
    from vis_zephyr_tpu_torch.experiments import paired_slot_attention_probe as pprobe
    from vis_zephyr_tpu_torch.ops import paged_attention as pa

    # Every served phase ran before this one: neither kernel may have launched.
    if pa.batched_launches or pa.paired_launches:
        raise AssertionError(f"K10 or K11 launched on a served path: {pa.batched_launches}, "
                             f"{pa.paired_launches}")
    pa.batched_launches = pa.paired_launches = 0
    batched = bprobe.main(["--seed", str(seed)])
    paired = pprobe.main(["--seed", str(seed)])
    counts = {"k10": pa.batched_launches, "k11": pa.paired_launches}
    checks = {"batched": batched["vs_plain"], "batched vs K3": batched["vs_k3"]}
    for key, value in paired.items():
        if key.startswith("P"):
            checks[f"paired {key}"] = value["vs_plain"]
            checks[f"paired {key} vs K3"] = value["vs_k3"]
            checks[f"paired {key}, the first design"] = value["walk_vs_plain"]
    # Every timed route's layer-0 output at both timed shapes against the
    # plain version on the same inputs (`time_routes`).
    for probe, res in (("batched", batched), ("paired", paired)):
        for shape, timed in res["times"].items():
            for tag, value in timed["checks"].items():
                checks[f"{probe} {shape} {tag}"] = value
    bad = {k: v for k, v in checks.items() if not (v["rel_err"] <= 1e-2 and v["cosine"] >= 0.9999)}
    if bad:
        raise AssertionError(f"attn_probes: a probe's numerics check failed: {bad}")
    print(f"attn_probes: {len(checks)} probe checks within per slot 1e-2 and cosine 0.9999, "
          f"every timed route at both timed shapes among them")
    print(f"attn_probes: launches in the probes' runs K10 {counts['k10']}, K11 {counts['k11']}")
    grouped = check_grouped(gen)
    times = time_grouped(seed, batched["times"], paired["times"])
    # K11's build: tensor-core products, TMA boxes and bulk copies, no spills.
    sass = sass_counts("paged_attn_paired_kernel", K3_SASS_OPS)
    resources = resource_usage("paged_attn_paired_kernel")
    print(f"K11 SASS (paged_attn_paired_kernel): {sass}; registers at entry {resources['reg']}, "
          f"stack frame {resources['stack']} bytes, local {resources['local']}")
    if not all(sass[op] for op in K3_SASS_OPS):
        raise AssertionError(f"K11: no HMMA, UTMALDG or UBLKCP in its SASS: {sass}")
    times["paged_attn_paired"].update(sass=sass, resources=resources)
    return dict(counts, max_abs_err=grouped, times=times,
                probes={"batched": batched["times"], "paired": paired["times"]})


PHASES = ("kernels", "slice1", "paged", "batch", "writefirst", "spec", "multistep", "profile",
          "precision", "int8", "mlp_probe", "int4", "train", "attn_probes")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one batched decode step and one verify step "
                         "(torch.profiler)")
    ap.add_argument("--phases", default=None,
                    help=f"comma-separated subset of {', '.join(PHASES)}; prints no result line")
    args = ap.parse_args(argv)
    full = [p for p in PHASES if p != "profile" or args.profile]
    phases = full if args.phases is None else args.phases.split(",")
    if not set(phases) <= set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phase in {phases}")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {card}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from vis_zephyr_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.lib()
    print(f"build: nvcc {' '.join(_kernels.NVCC_FLAGS)}, one process per source -> "
          f"{_kernels.LIB} in {time.perf_counter() - t0:.1f} s")

    clock = [time.perf_counter()]

    def done(phase: str) -> None:
        now = time.perf_counter()
        print(f"phase {phase}: {now - clock[0]:.1f} s")
        clock[0] = now

    gen = torch.Generator("cuda").manual_seed(args.seed)
    dense, dense8, int8_logits = {}, {}, None
    if "kernels" in phases:
        k1 = check_flash(gen)
        k78 = check_flash_bwd(gen)
        done("kernels K1, K7, K8")
        k2 = check_cache_append(gen)
        k3 = check_paged_attention(gen)
        k4 = check_paged_rows(gen)
        k3_rows = check_paged_attention_rows(gen)
        k3_single = check_paged_single(gen)
        k4_update = check_paged_update(gen)
        done("kernels K1-K4")
        k5 = check_quant_matmul(gen)
        done("kernels K5")
        k6 = check_quant_matmul_int4(gen)
        done("kernels K6")
        k9 = check_fused_mlp(gen)
        done("kernels K9")
    model = None
    if set(phases) - {"kernels", "train", "attn_probes"}:
        model, cfg = build_model(args.seed)
    if "slice1" in phases:
        dense = run_slice(model, cfg, args.seed, args.max_new_tokens, card)
        done("slice1")
    if "paged" in phases:
        paged = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card)
        done("paged")
    if "batch" in phases:
        batch = run_fixed_batch(model, cfg, args.seed)
        done("batch")
    if "writefirst" in phases:
        from vis_zephyr_tpu_torch.ops import paged_attention as pa

        pa.attn_launches = pa.update_launches = 0
        writefirst = run_writefirst(model, cfg, args.seed)
        run_step_profile(model, cfg, args.seed, card)
        done("writefirst")
    if "spec" in phases:
        spec_dense = run_spec_dense(model, cfg, args.seed, args.max_new_tokens, card)
        # The same burst without speculation first, for the comparison only.
        unspec = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, n=16,
                                  label="spec paged, lookahead 0", repeat=True)
        spec_paged = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, n=16,
                                      label="spec paged", lookahead=SPEC_LOOKAHEAD, repeat=True)
        agree = sorted(first_divergence(spec_paged["streams"][sid], words)
                       for sid, words in unspec["streams"].items())
        print(f"spec paged: the burst of 16 with --lookahead {SPEC_LOOKAHEAD}: "
              f"{spec_paged['tokens_per_s']:.1f} tokens/s, TTFT median "
              f"{spec_paged['ttft_median'] * 1e3:.1f} ms; without: {unspec['tokens_per_s']:.1f} "
              f"tokens/s, {unspec['ttft_median'] * 1e3:.1f} ms; the two replies of a session agree "
              f"on their first {agree} of {args.max_new_tokens} tokens (other steps share other "
              f"batches: bf16 ties may break apart) [{card}]")
        run_spec_batch(model, cfg, args.seed)
        run_verify_replay(model, cfg, args.seed, card)
        done("spec")
    if "multistep" in phases:
        run_burst_batch(model, cfg, args.seed, card)
        multistep_paged = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card,
                                           label="multistep paged", multi_step=BURST_STEPS)
        multistep_dense = run_burst_dense(model, cfg, args.seed, args.max_new_tokens, card)
        run_burst_timing(model, cfg, args.seed, card)
        done("multistep")
    if "profile" in phases:
        run_profile(model, cfg, args.seed, card)
        run_profile(model, cfg, args.seed, card, label="spec profile", lookahead=SPEC_LOOKAHEAD)
        run_dense_profile(model, cfg, args.seed, card)
        run_prefill_profile(model, cfg, args.seed, card)
        done("profile")
    if "precision" in phases:
        if "slice1" not in phases:
            raise SystemExit("chip_smoke: the precision phase needs slice1")
        torch.cuda.empty_cache()
        check_precision(model, cfg, *dense["precision_inputs"])
        done("precision")
    if "int8" in phases:
        # --load-8bit on both served paths: a fresh model from the same seed,
        # quantized in place after the bf16 one is gone.
        if "batch" not in phases:
            raise SystemExit("chip_smoke: the int8 phase needs batch (its bf16 reference)")
        del model
        dense.pop("precision_inputs", None)
        gc.collect()  # the servers' handler classes hold their engines in cycles
        torch.cuda.empty_cache()
        model, cfg = quantize_model(args.seed, card, bits=8)
        dense8 = run_slice(model, cfg, args.seed, args.max_new_tokens, card, n_requests=2,
                           label="int8 dense")
        paged8 = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, n=16,
                                  label="int8 paged")
        int8_logits = run_fixed_batch_quant(model, cfg, args.seed, batch, card)
        run_verify_routes(model, cfg, args.seed, card)
        if "multistep" in phases:
            run_burst_timing(model, cfg, args.seed, card, label="int8 multistep",
                             sizes=(BURST_STEPS,), dense=False)
        done("int8")
        if "profile" in phases:
            run_profile(model, cfg, args.seed, card, label="int8 profile")
            run_profile(model, cfg, args.seed, card, label="int8 spec profile",
                        lookahead=SPEC_LOOKAHEAD)
            done("int8 profile")
    if "mlp_probe" in phases:
        # The port's probe run (numerics, then K9 at both tilings and the K5
        # route in CUDA graphs of 32 chained calls), and K9 on a real int8
        # layer's MLP: layer 0 of the int8 phase's model, else a full-width
        # MLP quantized alike.
        from vis_zephyr_tpu_torch.experiments import fused_mlp_matvec_probe as probe

        probe.launches = 0
        probe_run = probe.main(["--seed", str(args.seed)])
        if "int8" in phases:
            layer = model.decoder.model.layers[0]
            run_mlp_layer(layer.mlp, cfg.decoder.hidden_size, layer.post_attention_layernorm.weight,
                          cfg.decoder.rms_norm_eps, "layer 0 of the int8 model", card)
        else:
            mlp, hidden, norm, eps = standalone_int8_mlp(args.seed)
            run_mlp_layer(mlp, hidden, norm, eps, "a full-width MLP quantized as load_8bit does",
                          card)
            del mlp
        mlp_probe = {"k9": probe.launches}
        print(f"mlp_probe: K9 launches {probe.launches} (the probe's eager warm-ups and graph "
              f"captures, and the layer check)")
        done("mlp_probe")
    if "int4" in phases:
        # --load-4bit on both served paths: int4 decoder, int8 Q-Former, again a
        # fresh model from the same seed once the one before is gone.
        if "batch" not in phases:
            raise SystemExit("chip_smoke: the int4 phase needs batch (its bf16 reference)")
        del model
        for run in (dense, dense8):
            run.pop("precision_inputs", None)
        gc.collect()
        torch.cuda.empty_cache()
        model, cfg = quantize_model(args.seed, card, bits=4)
        dense4 = run_slice(model, cfg, args.seed, args.max_new_tokens, card, n_requests=2,
                           label="int4 dense")
        paged4 = run_paged_server(model, cfg, args.seed, args.max_new_tokens, card, n=16,
                                  label="int4 paged")
        run_fixed_batch_quant(model, cfg, args.seed, batch, card, int8=int8_logits)
        run_verify_routes(model, cfg, args.seed, card)
        if "multistep" in phases:
            run_burst_timing(model, cfg, args.seed, card, label="int4 multistep",
                             sizes=(BURST_STEPS,), dense=False)
        done("int4")
        if "profile" in phases:
            run_profile(model, cfg, args.seed, card, label="int4 profile")
            done("int4 profile")
    if "train" in phases:
        # The trainer builds its own full-width model from the seed: the
        # served one goes first.
        del model
        for run in (dense, dense8):
            run.pop("precision_inputs", None)
        gc.collect()
        torch.cuda.empty_cache()
        trained = run_train(args.seed, card)
        done("train")
    if "attn_probes" in phases:
        # Last, so that the K10 and K11 counters, still 0 when it starts, show
        # that no served phase launched either kernel.
        model = None
        gc.collect()
        torch.cuda.empty_cache()
        attn = run_attn_probes(args.seed, gen, card)
        done("attn_probes")
    if phases != full:
        print(f"partial run of phases {phases}: no result line")
        return

    # The counts of the ten served runs (bf16, int8 and int4 weights on each
    # path, speculation on each path and multi-step bursts on each path),
    # each set to 0 just before its run and read just after it. `launches` is
    # their sum and `launches_by_path` says which run gave what.
    runs = {"dense": dense, "paged": paged, "dense_int8": dense8, "paged_int8": paged8,
            "dense_int4": dense4, "paged_int4": paged4, "spec_dense": spec_dense,
            "spec_paged": spec_paged, "multistep_dense": multistep_dense,
            "multistep_paged": multistep_paged, "writefirst": writefirst, "mlp_probe": mlp_probe,
            "train": trained["train"], "train_lora": trained["train_lora"],
            "attn_probes": attn}
    by_path = {name: {path: run.get(key, 0) for path, run in runs.items()}
               for name, key in (("flash_fwd", "k1"), ("dense_cache_append", "k2"),
                                 ("paged_attn_decode", "k3"), ("paged_kv_rows", "k4"),
                                 ("quant_matmul_int8", "k5"), ("quant_matmul_int4", "k6"),
                                 ("paged_kv_update", "kvu"), ("flash_bwd_dkv", "k7"),
                                 ("flash_bwd_dq", "k8"), ("fused_mlp_matvec", "k9"),
                                 ("paged_attn_batched", "k10"), ("paged_attn_paired", "k11"))}
    # Each path must have gone through its own kernels (chunked admission
    # attends its scratch cache with plain attention, so K1 is the dense path's).
    dense_kernels = ("flash_fwd", "dense_cache_append")
    paged_kernels = ("dense_cache_append", "paged_attn_decode", "paged_kv_rows")
    both = ("quant_matmul_int8", "quant_matmul_int4")  # the int4 Q-Former stays int8
    on_path = {"dense": dense_kernels, "paged": paged_kernels,
               "dense_int8": dense_kernels + ("quant_matmul_int8",),
               "paged_int8": paged_kernels + ("quant_matmul_int8",),
               "dense_int4": dense_kernels + both, "paged_int4": paged_kernels + both,
               "spec_dense": dense_kernels,
               "multistep_dense": dense_kernels, "multistep_paged": paged_kernels,
               "spec_paged": ("dense_cache_append", "paged_attn_decode", "paged_kv_update"),
               "writefirst": ("paged_attn_decode", "paged_kv_update"),
               "mlp_probe": ("fused_mlp_matvec",),
               "train": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
               "train_lora": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
               "attn_probes": ("paged_attn_batched", "paged_attn_paired")}
    if not all(by_path[name][path] > 0 for path, names in on_path.items() for name in names):
        raise AssertionError(f"a kernel was never launched on its served path: {by_path}")
    if any(n for name in ("paged_attn_batched", "paged_attn_paired")
           for path, n in by_path[name].items() if path != "attn_probes"):
        raise AssertionError(f"K10 or K11 launched outside the attention probes: {by_path}")
    paged_py = "vis_zephyr_tpu/ops/paged_attention.py"
    kernels = [
        dict(name="flash_fwd", source="vis_zephyr_tpu_torch/csrc/flash_fwd.cu",
             replaces="vis_zephyr_tpu/ops/flash_attention.py:42",
             max_abs_err=k1["max_abs_err"], **k1["times"][256], by_shape=k1["times"],
             sass=k1["sass"]),
        dict(name="dense_cache_append", source="vis_zephyr_tpu_torch/csrc/dense_cache_append.cu",
             replaces="vis_zephyr_tpu/ops/kv_cache.py:37",
             max_abs_err=k2["max_abs_err"], **k2["times"]),
        dict(name="paged_attn_decode", source="vis_zephyr_tpu_torch/csrc/paged_attn_decode.cu",
             replaces=f"{paged_py}:109, {paged_py}:417, {paged_py}:604 and {paged_py}:911",
             max_abs_err=max(k3["max_abs_err"], k3_rows["max_abs_err"], k3_single["max_abs_err"]),
             **k3["times"], at_2048=k3["at_2048"], by_rows=k3_rows["by_rows"],
             rows_7_8=k3_single["times"], sass=k3["sass"], resources=k3["resources"]),
        dict(name="paged_kv_rows", source="vis_zephyr_tpu_torch/csrc/paged_kv_rows.cu",
             replaces=f"{paged_py}:1691", max_abs_err=k4["max_abs_err"], **k4["times"]),
        # Timed at gate/up, M = 32; `passes` holds a decoder pass at each M.
        dict(name="quant_matmul_int8", source="vis_zephyr_tpu_torch/csrc/quant_matmul_int8.cu",
             replaces="vis_zephyr_tpu/ops/quant_matmul.py:34", max_abs_err=k5["max_abs_err"],
             **k5["times"], passes=k5["passes"], sass=k5["sass"], resources=k5["resources"]),
        dict(name="quant_matmul_int4", source="vis_zephyr_tpu_torch/csrc/quant_matmul_int4.cu",
             replaces="vis_zephyr_tpu/ops/quant_matmul.py:116", max_abs_err=k6["max_abs_err"],
             **k6["times"], passes=k6["passes"], sass=k6["sass"], resources=k6["resources"]),
        dict(name="paged_kv_update", source="vis_zephyr_tpu_torch/csrc/paged_kv_rows.cu",
             replaces=f"{paged_py}:1482 and {paged_py}:1574",
             max_abs_err=k4_update["max_abs_err"], **k4_update["times"]),
        # Timed at causal B=1, T=S=2048; `by_shape` holds T=S=256 and the
        # trainer's B=8 with padded keys too.
        dict(name="flash_bwd_dkv", source="vis_zephyr_tpu_torch/csrc/flash_bwd.cu",
             replaces="vis_zephyr_tpu/ops/flash_attention.py:200",
             max_abs_err=k78["dkv"]["max_abs_err"], **k78["dkv"]["times"][2048],
             by_shape=k78["dkv"]["times"], sass=k78["dkv"]["sass"],
             resources=k78["dkv"]["resources"]),
        dict(name="flash_bwd_dq", source="vis_zephyr_tpu_torch/csrc/flash_bwd.cu",
             replaces="vis_zephyr_tpu/ops/flash_attention.py:262",
             max_abs_err=k78["dq"]["max_abs_err"], **k78["dq"]["times"][2048],
             by_shape=k78["dq"]["times"], sass=k78["dq"]["sass"],
             resources=k78["dq"]["resources"]),
        # Timed at M = 1 (single-stream decode) at the default block_i; `by_M` holds
        # M = 8 and both tilings, the K5 route and the int8-pack yardstick.
        dict(name="fused_mlp_matvec", source="vis_zephyr_tpu_torch/csrc/fused_mlp_matvec.cu",
             replaces="experiments/fused_mlp_matvec_probe.py:38", max_abs_err=k9["max_abs_err"],
             **{key: k9["times"][1][key] for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                                     "bound_ms", "bound_by", "k5_route_ms",
                                                     "k5_route_device_ms", "int8pack_route_ms")},
             by_M=k9["times"], probe_us_per_layer=probe_run.get("us_per_layer")),
        # At the probes' bench shape (128 slots of 640 tokens, one layer);
        # `probe_step_ms` holds each probe's routes per 32-layer step at 128
        # and at 32 slots.
        dict(name="paged_attn_batched", source="vis_zephyr_tpu_torch/csrc/paged_attn_grouped.cu",
             replaces="experiments/batched_paged_attention_probe.py:19",
             max_abs_err=attn["max_abs_err"]["k10"], **attn["times"]["paged_attn_batched"]),
        dict(name="paged_attn_paired", source="vis_zephyr_tpu_torch/csrc/paged_attn_paired.cu",
             replaces="experiments/paired_slot_attention_probe.py:28",
             max_abs_err=attn["max_abs_err"]["k11"], **attn["times"]["paged_attn_paired"]),
    ]
    for kernel in kernels:
        counts = by_path[kernel["name"]]
        kernel.update(route="cuda", launches=sum(counts.values()), launches_by_path=counts)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
