"""The served steps' kernel launches and device time, for comparing two
checkouts of the port in one call on the card.

Run from a checkout's root, it builds the full-width model from the seed
(`chip_smoke.build_model`, random bf16 weights) and profiles three steps
with torch.profiler: one dense decode step (B = 1, a text prompt of 170
tokens: `serve/generate.py::decode_step`), and one batched decode step and
one batched verify step (S = 5) of 32 slots over int8 KV-fused pools
(`PagedBatcher.step`, through `chip_smoke.admitted_batcher`). For each: the
wall (host clock around steps that end in a synchronize, median of 16),
device busy (kernel time a step; one stream), kernel launches a step and
the largest device items. With `--multi-step N` (N > 1) it profiles the
burst form beside each decode step too: a burst of N steps replayed as CUDA
graphs (`serve/generate.py::decode_multi_step` over the dense step's bucket
cache; `PagedBatcher.step` with `multi_step` N), each reading divided by N,
so that a row reads per token.

It uses only helpers that earlier checkouts of `chip_smoke.py` hold too
(`build_model`, `admitted_batcher`, `direct_requests`, `device_items`), so
this file copied into an earlier checkout profiles that checkout's port
(the burst form needs a checkout that has it):

    python -m vis_zephyr_tpu_torch.experiments.step_profile [--seed N] [--label NAME]
        [--multi-step N]

Needs the card. Prints a line a step on lines that name the card, then the
results as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from ..serve.generate import decode_step, prefill
from .probe_common import card_name

DENSE_TOKENS = 170  # the prompt of PERF.md's dense decode step breakdown
LOOKAHEAD = 4


def profile_step(step, warm: int = 4, timed: int = 16, profiled: int = 8,
                 per_call: int = 1) -> dict:
    """`step()` run `warm` times, then `timed` times by the host clock, then
    `profiled` times under torch.profiler (none when 0: no device reading).
    Each call runs `per_call` decode steps (a burst), and every reading is
    per step."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_items

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(timed):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls = [w / per_call for w in walls]
    wall = statistics.median(walls)
    got = {"wall_ms": wall, "wall_min_ms": min(walls), "wall_max_ms": max(walls)}
    if not profiled:
        return got
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            step()
        torch.cuda.synchronize()
    rows, busy = device_items(prof, profiled * per_call)
    return dict(got, device_ms=busy, idle_share=1 - busy / wall,
                launches=sum(r[2] for r in rows), items=rows)


def dense_decode(model, cfg, seed: int):
    """A closure running one dense decode step (B = 1) after a text prefill of
    DENSE_TOKENS tokens; each call appends a row to the cache."""
    rng = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, cfg.decoder.vocab_size, (1, DENSE_TOKENS), generator=rng).cuda()
    state = {"cache": prefill(model, ids, None, None, cfg, 512)[1]}
    token = torch.tensor([7], device="cuda")

    def step():
        state["cache"] = decode_step(model, state["cache"], token, cfg)[1]

    return step, state


def paged_eager_step(b):
    """A closure running one eager decode step of PagedBatcher `b`
    (`_paged_step`, the form the CPU and `plain_versions()` run, as the
    batcher served every step before its steps were replayed as CUDA
    graphs), with its copy of the tokens to the host and the host's
    transitions."""
    from ..serve.paged import _paged_step

    def step():
        b._active_dev.copy_(torch.from_numpy(b.active))
        _, b.last_logits = _paged_step(b.model, b.kp, b.vp, (b.ksp, b.vsp), b.page_table,
                                       b.lengths, b.token, b._active_dev, b.generator, b.cfg,
                                       b.sampling)
        b._process_burst(b.token.cpu().numpy()[None], b.active[None].copy())

    return step


def dense_burst(model, cfg, seed: int, n: int):
    """A closure running one burst of `n` dense decode steps (B = 1, greedy)
    after a text prefill of DENSE_TOKENS tokens into the model's burst cache
    of 1024 slots, ending in the burst's one copy of its tokens to the host;
    and the bucket's `StepGraphs` (its captures and memory)."""
    from ..serve.generate import SamplingConfig, burst_cache, decode_multi_step

    rng = torch.Generator().manual_seed(seed)
    ids = torch.randint(3, cfg.decoder.vocab_size, (1, DENSE_TOKENS), generator=rng).cuda()
    fixed, graphs = burst_cache(model, cfg, 1, 1024, ids)
    last, cache, _ = prefill(model, ids, None, None, cfg, 1024, cache=fixed)
    state = {"token": last.argmax(-1)}
    sampling = SamplingConfig(eos_token_id=-1)

    def step():
        toks, _, state["token"] = decode_multi_step(model, cache, state["token"], None, cfg,
                                                    sampling, n, graphs)
        toks.tolist()

    return step, graphs


def show_step(head: str, label: str, got: dict, card: str, n: int = 12) -> None:
    """A step's profile: its wall, device busy, idle share and launches, the
    `n` largest device items, and K2's and K4's rows."""
    print(f"{head}: wall median {got['wall_ms']:.2f} ms (min {got['wall_min_ms']:.2f}, max "
          f"{got['wall_max_ms']:.2f}), device busy {got['device_ms']:.2f} ms per step, idle "
          f"share {got['idle_share']:.2f}, {got['launches']:.1f} kernel launches per step "
          f"[{card}]", flush=True)
    rows = got["items"]
    for i, (key, ms, count) in enumerate(rows):
        if i < n or "dense_cache_append" in key or "paged_kv_rows" in key:
            print(f"{label}:   {ms:8.3f} ms  {count:6.1f} launches/step  {key[:90]}")
    if not rows:
        print(f"{label}: the profiler reported no device time")


def main(argv=None) -> dict:
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--multi-step", type=int, default=1,
                    help="also profile bursts of N decode steps (N > 1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: needs a CUDA card")
    card = card_name()
    model, cfg = chip_smoke.build_model(args.seed)
    out = {}
    step, _ = dense_decode(model, cfg, args.seed)
    out["dense_decode"] = profile_step(step)
    n = args.multi_step
    if n > 1:
        step, _ = dense_burst(model, cfg, args.seed, n)
        out[f"dense_burst{n}"] = profile_step(step, warm=1, timed=4, profiled=2, per_call=n)
    requests = chip_smoke.direct_requests(cfg, args.seed, 32)
    long = dict(max_new_tokens=512, num_pages=1 + 32 * 16)  # the budget for every step here
    runs = [("paged_decode", {}, 1)]
    if n > 1:
        runs.append((f"paged_burst{n}", dict(long, multi_step=n), n))
    runs.append(("paged_verify", dict(long, lookahead=LOOKAHEAD), 1))
    for name, extra, per_call in runs:
        b = chip_smoke.admitted_batcher(model, cfg, requests, 32, kv_quant=True, kv_fused=True,
                                        **extra)
        counts = dict(warm=1, timed=4, profiled=2) if per_call > 1 else {}
        out[name] = profile_step(b.step, per_call=per_call, **counts)
        if int(b.active.sum()) != 32:
            raise AssertionError(f"step_profile {name}: a slot finished inside the profile")
        del b
        torch.cuda.empty_cache()
    for name, got in out.items():
        show_step(f"{args.label}, {name}", f"{args.label}, {name}", got, card)
    print(json.dumps({name: {k: v for k, v in got.items() if k != "items"}
                      for name, got in out.items()}))
    return out


if __name__ == "__main__":
    main()
