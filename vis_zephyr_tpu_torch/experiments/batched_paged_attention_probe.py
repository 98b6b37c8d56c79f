"""Batched-head paged attention probe: decode attention over KV-fused int8
pools with the self-term, one block a slot over all its kv heads, in kernel
K10 (`csrc/paged_attn_grouped.cu`, wrapper `ops/paged_attention.py::
paged_attention_batched`), against K3 (`paged_attention_fa` without tilings,
the kernel every served decode step runs).

Port of `experiments/batched_paged_attention_probe.py` (its Pallas kernel
`_batched_kernel` is the TPU kernel K10 replaces, `fa_batched` its wrapper).
What the probe asks: does a grid cell that owns a slot and every kv head of
it, stepping the online softmax over blocks of `pages_per_block` pages, run
the served configuration faster than the production kernel? The pools keep
the port's page-major layout (`[N, Hkv, 2·ps, D]` int8, scales
`[N, Hkv, 2·ps]` f32); `from_probe_arrays` takes the JAX probe's
(`[Hkv, N, 2·ps, D]`, `[Hkv, N, 1, 2·ps]`) to it. `page_offset` stands for
the JAX probe's `table + i * P` per layer.

    python -m vis_zephyr_tpu_torch.experiments.batched_paged_attention_probe [--device cpu]

runs the numerics check (slots of 3, 130, 257 and 505 tokens, K10 at
`pages_per_block` 2 against its plain version and against K3), then (on
the card) times 32 calls, one per layer's pools, captured in one CUDA graph:
K3 and K10 at `pages_per_block` 1, 5 and 8, at the probe's bench shape (128
slots of 640 tokens) and at 32 slots of 60 to 800 tokens (the served
step's); ms per 32-layer step-equivalent, µs per layer and the bound, on
lines that name the card. On the CPU it runs the check alone: a time is a
card's.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..config import VisZephyrConfig
from ..ops import paged_attention as pa
from .probe_common import agreement, card_name, graph_replay_ms

HBM_BYTES_PER_S = 3.35e12   # one H100 SXM at 700 W (NVIDIA's data sheet)
BF16_FLOPS = 989e12
BENCH_SLOTS, BENCH_PROMPT, PAGE = 128, 640, 128  # the probes' bench shape
SERVED_SLOTS = 32           # `chip_smoke.py`'s served batch: 60 to 800 tokens a slot
TABLE_PAGES = 2048 // PAGE  # a slot's table: the served cache of 2048 tokens
PAGES_PER_BLOCK = (1, 5, 8)


def fa_batched(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
               pages_per_block: int = 8, window=None, page_offset: int = 0) -> torch.Tensor:
    """The JAX probe's `fa_batched` in the port's pool layout: q [B, 1, Hq, D]
    bf16, k_pages [N, Hkv, 2·ps, D] int8, k_scales [N, Hkv, 2·ps] f32, table
    [B, pps] (plus `page_offset`), lengths and q_offs [B] int32, k_new / v_new
    [B, Hkv, D]. K10 on a CUDA tensor, its plain version on a CPU tensor."""
    return pa.paged_attention_batched(q, k_pages, page_table, lengths, q_offs, k_new, v_new,
                                      k_scales, pages_per_block, window, page_offset=page_offset)


def from_probe_arrays(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales):
    """The JAX probes' arguments (numpy, or anything `np.asarray` takes; bf16
    arrays are widened exactly) as the port's CPU tensors, in the order
    `fa_batched` takes them: the pools through `pools_from_jax_layout`."""
    kp, _, ksc, _ = pa.pools_from_jax_layout(np.asarray(k_pages), None,
                                             np.asarray(k_scales, np.float32))

    def bf16(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    def i32(x):
        return torch.from_numpy(np.array(x, np.int32))

    return (bf16(q), torch.from_numpy(kp), i32(page_table), i32(lengths), i32(q_offs),
            bf16(k_new), bf16(v_new), torch.from_numpy(ksc))


# -- shared with the paired probe ------------------------------------------------------


def check_case(lengths: List[int], device, seed: int, Hq: int = 8, Hkv: int = 2, D: int = 128,
               ps: int = PAGE, pps: int = 4) -> dict:
    """The probes' numerics inputs in the port's layout: int8 codes
    round(20·N(0, 1)) clipped to ±127, scales |N(0, 1)| + 0.5, slot b on
    pages 1 + b·pps …, q, k_new, v_new 0.3·N(0, 1) in bf16, q_offs =
    lengths."""
    gen = torch.Generator(device).manual_seed(seed)
    B = len(lengths)
    N = 1 + B * pps
    kp = torch.round(torch.randn((N, Hkv, 2 * ps, D), generator=gen, device=device) * 20)
    kp = kp.clamp_(-127, 127).to(torch.int8)
    ksc = torch.randn((N, Hkv, 2 * ps), generator=gen, device=device).abs_() + 0.5
    table = (1 + torch.arange(B * pps, device=device, dtype=torch.int32)).reshape(B, pps)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)

    def small(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.3).to(torch.bfloat16)

    return dict(q=small(B, 1, Hq, D), k_pages=kp, k_scales=ksc, page_table=table, lengths=lens,
                q_offs=lens.clone(), k_new=small(B, Hkv, D), v_new=small(B, Hkv, D))


def k3(case: dict, window=None, page_offset: int = 0) -> torch.Tensor:
    """The production kernel on the same inputs: `paged_attention_fa` with
    no tiling (K3; its plain version on the CPU)."""
    return pa.paged_attention_fa(case["q"], case["k_pages"], None, case["page_table"],
                                 case["lengths"], case["q_offs"], sliding_window=window,
                                 k_scales=case["k_scales"], k_new=case["k_new"],
                                 v_new=case["v_new"], page_offset=page_offset)


def grouped_plain(case: dict, pages_per_block: int, window=None, splits: int = 1) -> torch.Tensor:
    return pa.paged_attention_grouped_plain(
        case["q"], case["k_pages"], case["page_table"], case["lengths"], case["q_offs"],
        case["k_new"], case["v_new"], case["k_scales"], pages_per_block, window, splits=splits)


def bench_case(device, seed: int, slots: int, lengths: List[int], layers: int) -> dict:
    """`layers` layers of KV-fused int8 pools (random codes, scales in [0.5,
    1.5)), each slot with the pages its length needs inside a table of
    `TABLE_PAGES` (the rest page 0), and the query, k_new and v_new."""
    dec = VisZephyrConfig().decoder
    Hq, Hkv, D = dec.num_heads, dec.num_kv_heads, dec.head_dim
    gen = torch.Generator(device).manual_seed(seed)
    per_slot = -(-(max(lengths) + 4) // PAGE)
    per_layer = 1 + slots * per_slot
    kp = torch.randint(-127, 128, (layers * per_layer, Hkv, 2 * PAGE, D), generator=gen,
                       device=device, dtype=torch.int8)
    ksc = torch.rand((layers * per_layer, Hkv, 2 * PAGE), generator=gen, device=device) + 0.5
    table = torch.zeros((slots, TABLE_PAGES), dtype=torch.int32, device=device)
    table[:, :per_slot] = (1 + torch.arange(slots * per_slot, dtype=torch.int32,
                                            device=device)).reshape(slots, per_slot)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((slots, 1, Hq, D), generator=gen, device=device).to(torch.bfloat16)
    kn = torch.randn((slots, Hkv, D), generator=gen, device=device).to(torch.bfloat16)
    return dict(q=q, k_pages=kp, k_scales=ksc, page_table=table, lengths=lens,
                q_offs=lens.clone(), k_new=kn, v_new=kn, per_layer=per_layer, layers=layers)


def layer_bound(case: dict) -> Tuple[float, str, float]:
    """(ms, "bytes" | "operations", MB) of one layer's call: each valid K and
    V row read once with its scale, q, k_new, v_new, the table, lengths and
    q_offs read once, the output written once; 4·Hq·D flops a key (q·k and
    p·v) and a self-term."""
    B, _, Hq, D = case["q"].shape
    Hkv = case["k_pages"].shape[1]
    tokens = int(case["lengths"].sum())
    n_bytes = (tokens * Hkv * 2 * (D + 4) + 2 * 2 * case["q"].numel() + 2 * 2 * B * Hkv * D
               + 4 * case["page_table"].numel() + 8 * B)
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * Hq * D * (tokens + B) / BF16_FLOPS * 1e3
    return (by_bytes, "bytes", n_bytes / 1e6) if by_bytes >= by_ops else (
        by_ops, "operations", n_bytes / 1e6)


def layer_calls(case: dict, fn: Callable[[dict, int], torch.Tensor]) -> Callable[[], None]:
    """One call per layer of the case's pools, each on its own layer
    (`page_offset = layer · pages per layer`): a 32-layer step-equivalent."""
    def step():
        for layer in range(case["layers"]):
            fn(case, layer * case["per_layer"])
    return step


def served_lengths(seed: int, slots: int = SERVED_SLOTS) -> List[int]:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(60, 801, (slots,), generator=gen).tolist()


def time_routes(routes: Dict[str, Tuple[Callable[[dict, int], torch.Tensor], int]], device,
                seed: int, card: str, label: str) -> Dict[str, dict]:
    """Each route's 32-layer step-equivalent at the bench shape and at the
    served one, with the bound; prints one line a route and the fastest.
    A route is (call, pages_per_block of the plain version it is held
    against): its output on layer 0 of the timed inputs is compared with
    `paged_attention_grouped_plain` at that step (K3, one page a step, with
    1), per slot; the agreement is returned under "checks" for the caller
    to gate."""
    layers = VisZephyrConfig().decoder.num_layers
    shapes = {"B128": [BENCH_PROMPT] * BENCH_SLOTS, "B32": served_lengths(seed)}
    result = {}
    for shape, lengths in shapes.items():
        case = bench_case(device, seed, len(lengths), lengths, layers)
        bound, by, mb = layer_bound(case)
        times, checks, plain = {}, {}, {}
        for tag, (fn, plain_pages) in routes.items():
            if plain_pages not in plain:
                plain[plain_pages] = grouped_plain(case, plain_pages)
            checks[tag] = agreement(fn(case, 0), plain[plain_pages], per_slot=True)
            ms = graph_replay_ms(layer_calls(case, fn))
            times[tag] = ms
            print(f"{label} {shape} ({len(lengths)} slots, {sum(lengths)} tokens) {tag}: "
                  f"{ms:.4f} ms per {layers}-layer step-equivalent, {ms * 1e3 / layers:.2f} us "
                  f"per layer; bound {bound * layers:.4f} ms ({bound * 1e3:.2f} us a layer by "
                  f"{by}, {mb:.1f} MB) [{layers} calls in one CUDA graph, median of 20 replays; "
                  f"{card}]; layer 0 against the plain version at pages_per_block {plain_pages}: "
                  f"{checks[tag]}", flush=True)
        fastest = min(times, key=times.get)
        print(f"{label} {shape}: fastest {fastest} [{card}]", flush=True)
        result[shape] = dict(step_ms=times, layers=layers, bound_ms_per_layer=bound, bound_by=by,
                             mb_per_layer=mb, tokens=sum(lengths), fastest=fastest, checks=checks)
        del case, plain
        torch.cuda.empty_cache()
    return result


def device_of(args) -> Tuple[torch.device, bool, str]:
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (use --device cpu for the numerics check alone)")
    return device, on_card, card_name() if on_card else "CPU"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device, on_card, card = device_of(args)

    # Numerics: mixed lengths, K10 at pages_per_block 2 (bk 256) against its
    # plain version (the same blocks) and against K3 (one page a step: the
    # bf16 rounding of the probabilities moves).
    case = check_case([3, 130, 257, 512 - 7], device, args.seed)
    got = fa_batched(case["q"], case["k_pages"], case["page_table"], case["lengths"],
                     case["q_offs"], case["k_new"], case["v_new"], case["k_scales"],
                     pages_per_block=2)
    result = {"card": card, "vs_plain": agreement(got, grouped_plain(case, 2), per_slot=True),
              "vs_k3": agreement(got, k3(case), per_slot=True)}
    print(f"batched_paged_attention_probe numerics, B=4, Hq=8, Hkv=2, ps=128, pages_per_block 2: "
          f"against the plain version {result['vs_plain']}, against K3 {result['vs_k3']} [{card}]",
          flush=True)
    if not on_card:
        print("batched_paged_attention_probe: times are not measured on the CPU")
        return result
    del case

    def k10(ppcb):
        return lambda c, off: fa_batched(c["q"], c["k_pages"], c["page_table"], c["lengths"],
                                         c["q_offs"], c["k_new"], c["v_new"], c["k_scales"],
                                         pages_per_block=ppcb, page_offset=off)

    routes = {"k3": (lambda c, off: k3(c, page_offset=off), 1)}
    routes.update({f"k10_ppcb{n}": (k10(n), n) for n in PAGES_PER_BLOCK})
    result["times"] = time_routes(routes, device, args.seed, card, "batched_paged_attention_probe")
    return result


if __name__ == "__main__":
    main()
