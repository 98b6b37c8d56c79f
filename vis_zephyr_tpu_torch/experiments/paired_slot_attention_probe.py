"""Slot-grouped paged attention probe: the batched probe's function for
groups of `pair` consecutive slots, in kernel K11
(`csrc/paged_attn_paired.cu`, wrapper `ops/paged_attention.py::
paged_attention_paired`), against K3 and against K11's first design.

Port of `experiments/paired_slot_attention_probe.py` (its Pallas kernel
`_paired_kernel` is the TPU kernel K11 replaces, `fa_paired` its wrapper).
What the probe asks: on the TPU one grid cell of P slots divided a fixed
cost per cell and per block by P; does grouping P slots pay on the card?
K11 runs a block per (slot, kv head) with the blocks of a group adjacent, so
the grid does not shrink with P, pages come by TMA into a ring and both
products run on tensor cores. The first design (`vzt_paged_attn_paired_walk`
in `csrc/paged_attn_grouped.cu`, `paired_walk` here) walked a group's P
slots one after the other with the eight warps of one block, so B / P
blocks shared the card; it stays for the comparison. The TPU kernel walked
the group's widest block range in step, a member outside its own range
masked; here each slot walks its own blocks, which gives the same result.

    python -m vis_zephyr_tpu_torch.experiments.paired_slot_attention_probe [--device cpu]

runs the numerics check (pairs of very different lengths: 3 against 505, 130
against 1; K11 at P = 2 and 4, and at P = 2 with a window of 256, each at
`pages_per_block` 2 against its plain version at K11's split plan (two
splits on the card) and against K3, and on the card the first design
against its plain version), then (on the card) times K3, K11 and the first design at P = 2, 4
and 8 with `pages_per_block` 6 in CUDA graphs of 32 layer calls, at the
bench shape and the served one (see the batched probe). This covers
`experiments/fa_sb_probe.py`'s sweep of the slots a cell owns. On the CPU
it runs the check alone.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import _kernels
from ..ops import paged_attention as pa
from .batched_paged_attention_probe import (check_case, device_of, from_probe_arrays,
                                            grouped_plain, k3, time_routes)
from .probe_common import agreement

__all__ = ["fa_paired", "from_probe_arrays", "main", "paired_walk"]

PAIRS = (2, 4, 8)
BENCH_PAGES_PER_BLOCK = 6


def fa_paired(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
              pages_per_block: int = 6, window=None, pair: int = 2,
              page_offset: int = 0):
    """The JAX probe's `fa_paired` in the port's pool layout (arguments as
    `fa_batched`'s); like the probe it takes B a multiple of `pair`. K11 on a
    CUDA tensor, the plain version on a CPU tensor."""
    if pair < 2 or q.shape[0] % pair:
        raise ValueError(f"fa_paired: B = {q.shape[0]} must be a multiple of pair = {pair} >= 2")
    return pa.paged_attention_paired(q, k_pages, page_table, lengths, q_offs, k_new, v_new,
                                     k_scales, pages_per_block, window, page_offset=page_offset,
                                     pair=pair)


def paired_walk(q, k_pages, page_table, lengths, q_offs, k_new, v_new, k_scales,
                pages_per_block: int = 6, window=None, pair: int = 2,
                page_offset: int = 0) -> torch.Tensor:
    """K11's first design on CUDA tensors (`vzt_paged_attn_paired_walk`: one
    block of eight warps per group, walking the group's slots in turn),
    arguments as `fa_paired`'s; K10's arithmetic, so its plain version is
    `paged_attention_grouped_plain` with one split. A baseline for the
    probes, launched by no wrapper and counted by no launch counter."""
    B, _, Hq, D = q.shape
    N, Hkv, rows, _ = k_pages.shape
    out = torch.empty_like(q)
    code = _kernels.lib().vzt_paged_attn_paired_walk(
        q.data_ptr(), out.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), q_offs.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), B, Hq, Hkv, rows // 2, page_table.shape[1], int(pages_per_block),
        int(page_offset), int(window or 0), int(pair), float(D ** -0.5),
        _kernels.stream_ptr(q.device))
    _kernels.check(code, "vzt_paged_attn_paired_walk")
    return out


def case_splits(case: dict, pages_per_block: int) -> int:
    """K11's splits for `case` on this card (`paired_plan`; 1 on the CPU)."""
    if case["q"].device.type != "cuda":
        return 1
    B, _, _, _ = case["q"].shape
    _, Hkv, rows, _ = case["k_pages"].shape
    return pa.paired_plan(B, Hkv, rows // 2, case["page_table"].shape[1], pages_per_block,
                          _kernels.sm_count(case["q"].device.index))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device, on_card, card = device_of(args)

    case = check_case([3, 505, 130, 1, 257, 257, 512 - 7, 64], device, args.seed)
    result = {"card": card}
    for P, window in ((2, None), (4, None), (2, 256)):
        got = fa_paired(case["q"], case["k_pages"], case["page_table"], case["lengths"],
                        case["q_offs"], case["k_new"], case["v_new"], case["k_scales"],
                        pages_per_block=2, window=window, pair=P)
        splits = case_splits(case, 2)
        check = {"splits": splits,
                 "vs_plain": agreement(got, grouped_plain(case, 2, window, splits), per_slot=True),
                 "vs_k3": agreement(got, k3(case, window), per_slot=True)}
        if on_card:
            walk = paired_walk(case["q"], case["k_pages"], case["page_table"], case["lengths"],
                               case["q_offs"], case["k_new"], case["v_new"], case["k_scales"],
                               pages_per_block=2, window=window, pair=P)
            check["walk_vs_plain"] = agreement(walk, grouped_plain(case, 2, window), per_slot=True)
        result[f"P{P}_w{window}"] = check
        print(f"paired_slot_attention_probe numerics, B=8, P={P}, window {window}, "
              f"pages_per_block 2, {splits} split(s): against the plain version "
              f"{check['vs_plain']}, against K3 {check['vs_k3']}; the first design against the "
              f"plain version {check.get('walk_vs_plain', 'not run on the CPU')} [{card}]",
              flush=True)
    if not on_card:
        print("paired_slot_attention_probe: times are not measured on the CPU")
        return result
    del case

    def k11(P):
        return lambda c, off: fa_paired(c["q"], c["k_pages"], c["page_table"], c["lengths"],
                                        c["q_offs"], c["k_new"], c["v_new"], c["k_scales"],
                                        pages_per_block=BENCH_PAGES_PER_BLOCK, pair=P,
                                        page_offset=off)

    def walk(P):
        return lambda c, off: paired_walk(c["q"], c["k_pages"], c["page_table"], c["lengths"],
                                          c["q_offs"], c["k_new"], c["v_new"], c["k_scales"],
                                          pages_per_block=BENCH_PAGES_PER_BLOCK, pair=P,
                                          page_offset=off)

    routes = {"k3": (lambda c, off: k3(c, page_offset=off), 1)}
    routes.update({f"k11_P{P}_ppcb{BENCH_PAGES_PER_BLOCK}": (k11(P), BENCH_PAGES_PER_BLOCK)
                   for P in PAIRS})
    routes.update({f"walk_P{P}_ppcb{BENCH_PAGES_PER_BLOCK}": (walk(P), BENCH_PAGES_PER_BLOCK)
                   for P in PAIRS})
    result["times"] = time_routes(routes, device, args.seed, card, "paired_slot_attention_probe")
    return result


if __name__ == "__main__":
    main()
