"""K4's and K2's one-launch design against the kernels it replaced, on the
card in one call. The committed kernels come from the port's library; the
earlier sources, `paged_kv_rows.cu` and `dense_cache_append.cu` from the
directory `--baseline-dir`, are each built as a library of their own with
their own C entries (K4's `vzt_paged_kv_update` then took rows [L, B] at
absolute page ids and no strides). Each route is checked against the other
and timed: on the device (a CUDA graph of 10 calls, replayed) and issued
back to back (the host's wall over 50 calls ended by a synchronize).

Routes, at the served shapes (Hkv 8, D 128, pages of 128 rows):
- `k4_decode`: one decode step's rows of 32 layers, 32 slots, int8 KV-fused
  pools: the old `vzt_paged_kv_rows` against the committed one;
- `k4_verify`: a verify step's layer, 32 slots of S = 5 rows, int8 fused: the
  old route (S single-row calls of the old `vzt_paged_kv_update`, each with
  its page-id add and two row copies, as `_paged_verify_step` made them)
  against one `paged_kv_update_layer_q` call;
- both K4 routes also on the form `no_scan`, the committed source with the
  search for a later row on the same pool row taken out (its cost; the
  form's trash page is a race, so it is compared outside it);
- `k2_decode`, `k2_chunk`: the dense cache's append at B = 1, S = 2048, T = 1
  and T = 256, bf16: the old route (eager `apply_rope`, then the old copy
  entry) against one `dense_cache_update_rope` call.

    mkdir -p DIR
    git show COMMIT:vis_zephyr_tpu_torch/csrc/paged_kv_rows.cu > DIR/paged_kv_rows.cu
    git show COMMIT:vis_zephyr_tpu_torch/csrc/dense_cache_append.cu > DIR/dense_cache_append.cu
    python -m vis_zephyr_tpu_torch.experiments.kv_writer_forms --baseline-dir DIR

Needs the card and nvcc. Prints one line a route, on lines that name the
card, then the results as one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
import time

import torch

from ..config import DecoderConfig
from ..models.mistral import rope_cos_sin
from ..ops import _kernels
from ..ops import kv_cache
from ..ops import paged_attention as pa
from .probe_common import card_name, graph_replay_ms

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {"vzt_paged_kv_rows": [_P] * 8 + [_I] * 6 + [_P],
                  "vzt_paged_kv_update": [_P] * 8 + [_I] * 5 + [_P],
                  "vzt_dense_cache_append": [_P] * 5 + [_I] * 6 + [_P]}
SOURCES = {"paged_kv_rows.cu": ("vzt_paged_kv_rows", "vzt_paged_kv_update"),
           "dense_cache_append.cu": ("vzt_dense_cache_append",)}
NO_SCAN = ("  const int end = a.scan_all ? a.S * a.B : (s + 1) * a.B;",
           "  const int end = 0;")
CALLS = 10  # calls in the timed graph
B, HKV, D, PS, PPS = 32, 8, 128, 128, 16


def no_scan_source() -> str:
    text = open(os.path.join(_kernels.CSRC, "paged_kv_rows.cu")).read()
    if NO_SCAN[0] not in text:
        raise RuntimeError("paged_kv_rows.cu no longer holds the scan's bound: update NO_SCAN")
    return text.replace(*NO_SCAN)


def build_forms(src_dir: str, out_dir: str) -> dict:
    """entry name -> the old C entry, and "no_scan:" + name -> the form's:
    one nvcc process a source, at once."""
    with open(os.path.join(out_dir, "no_scan.cu"), "w") as f:
        f.write(no_scan_source())
    sources = {os.path.join(src_dir, name): ("", entries, OLD_SIGNATURES)
               for name, entries in SOURCES.items()}
    sources[os.path.join(out_dir, "no_scan.cu")] = (
        "no_scan:", SOURCES["paged_kv_rows.cu"], _kernels._SIGNATURES)
    jobs = {}
    for i, src in enumerate(sources):
        lib = os.path.join(out_dir, f"form{i}.so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", lib, src]
        jobs[src] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    entries = {}
    for src, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}{err}")
        handle = ctypes.CDLL(lib)
        prefix, names, signatures = sources[src]
        for name in names:
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = signatures[name], ctypes.c_int
            entries[prefix + name] = fn
    return entries


def issue_ms(fn, calls: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def timed(fn) -> dict:
    def calls():
        for _ in range(CALLS):
            fn()

    return {"device_ms": graph_replay_ms(calls) / CALLS, "issue_ms": issue_ms(fn)}


def int8_fused_pool(gen, pages: int):
    shape = (pages, HKV, 2 * PS, D)
    pool = torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
    return pool, torch.rand(shape[:3], generator=gen, device="cuda")


def k4_decode(old, gen) -> dict:
    L = 32
    P = 1 + B * 2
    pool, scales = int8_fused_pool(gen, L * P)
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    active[[3, 11, 30]] = False
    pages = torch.where(active, torch.randperm(P - 1, generator=gen, device="cuda")[:B] + 1, 0)
    offsets = torch.where(active, torch.randint(0, PS, (B,), generator=gen, device="cuda"), 0)
    pages, offsets = pages.to(torch.int32), offsets.to(torch.int32)
    ks = torch.randn(L, B, HKV, D, generator=gen, device="cuda").to(torch.bfloat16)
    vs = torch.randn(L, B, HKV, D, generator=gen, device="cuda").to(torch.bfloat16)
    pools = {name: (pool.clone(), scales.clone()) for name in ("old", "new", "no_scan")}

    def old_call():
        kp, ksc = pools["old"]
        _kernels.check(old["vzt_paged_kv_rows"](
            kp.data_ptr(), None, ksc.data_ptr(), None, ks.data_ptr(), vs.data_ptr(),
            pages.data_ptr(), offsets.data_ptr(), L, B, HKV, D, P, PS,
            _kernels.stream_ptr(kp.device)), "old vzt_paged_kv_rows")

    def new_call():
        kp, ksc = pools["new"]
        pa.paged_kv_update_rows_q(kp, None, ksc, None, ks, vs, pages, offsets)

    def no_scan_call():
        kp, ksc = pools["no_scan"]
        _kernels.check(old["no_scan:vzt_paged_kv_rows"](
            kp.data_ptr(), None, ksc.data_ptr(), None, ks.data_ptr(), vs.data_ptr(),
            pages.data_ptr(), offsets.data_ptr(), L, B, HKV, D, P, PS,
            _kernels.stream_ptr(kp.device)), "no_scan vzt_paged_kv_rows")

    return compare_k4({"old": old_call, "new": new_call, "no_scan": no_scan_call}, pools,
                      trash=torch.arange(L, device="cuda") * P)


def k4_verify(old, gen, S: int = 5) -> dict:
    L = 2
    P = 1 + B * PPS
    layer = 1
    pool, scales = int8_fused_pool(gen, L * P)
    table = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * PPS] + 1).reshape(B, PPS)
    lengths = torch.randint(60, 801, (B,), generator=gen, device="cuda").to(torch.int32)
    pos = lengths[:, None] + torch.arange(S, dtype=torch.int32, device="cuda")
    pages = torch.gather(table, 1, (pos // PS).long()).to(torch.int32).T.contiguous()
    offsets = (pos % PS).T.contiguous()
    k = torch.randn(B, S, HKV, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, S, HKV, D, generator=gen, device="cuda").to(torch.bfloat16)
    pools = {name: (pool.clone(), scales.clone()) for name in ("old", "new", "no_scan")}

    def old_call():  # `_paged_verify_step`'s loop before the rebuild
        kp, ksc = pools["old"]
        for s in range(S):
            page_ids = (pages[s] + layer * P)[None]
            k_s, v_s = k[:, s][None].contiguous(), v[:, s][None].contiguous()
            _kernels.check(old["vzt_paged_kv_update"](
                kp.data_ptr(), None, ksc.data_ptr(), None, k_s.data_ptr(), v_s.data_ptr(),
                page_ids.data_ptr(), offsets[s].data_ptr(), 1, B, HKV, D, PS,
                _kernels.stream_ptr(kp.device)), "old vzt_paged_kv_update")

    def new_call():
        kp, ksc = pools["new"]
        pa.paged_kv_update_layer_q(kp, None, ksc, None, k, v, pages, offsets, layer * P)

    def no_scan_call():
        kp, ksc = pools["no_scan"]
        _kernels.check(old["no_scan:vzt_paged_kv_update"](
            kp.data_ptr(), None, ksc.data_ptr(), None, k.data_ptr(), v.data_ptr(),
            pages.data_ptr(), offsets.data_ptr(), S, B, HKV, D, PS, layer * P, k.stride(1),
            k.stride(0), B, _kernels.stream_ptr(kp.device)), "no_scan vzt_paged_kv_update")

    return compare_k4({"old": old_call, "new": new_call, "no_scan": no_scan_call}, pools,
                      trash=torch.tensor([0, P], device="cuda"))


def compare_k4(calls, pools, trash) -> dict:
    """Each route once on its own copy of the pools, compared with the new
    one on every page but the trash pages (the old kernel raced there), then
    timed."""
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    live = torch.ones(pools["new"][0].shape[0], dtype=torch.bool, device="cuda")
    live[trash] = False
    for name in calls:
        if not all(torch.equal(a[live], b[live]) for a, b in zip(pools[name], pools["new"])):
            raise AssertionError(f"K4: the {name} route and the new one wrote different pools")
    return {"equal_outside_trash": True, **{name: timed(call) for name, call in calls.items()}}


def k2(old, gen, S: int, T: int, length: int) -> dict:
    dec = DecoderConfig()
    L = 32
    ck = torch.randn(L, 1, S, HKV, D, generator=gen, device="cuda").to(torch.bfloat16)
    cv = torch.randn(L, 1, S, HKV, D, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(1, T, HKV, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(1, T, HKV, D, generator=gen, device="cuda").to(torch.bfloat16)
    lengths = torch.tensor([length], dtype=torch.int32, device="cuda")
    positions = lengths[:, None] + torch.arange(T, dtype=torch.int32, device="cuda")
    cos, sin = rope_cos_sin(positions, D, dec.rope_theta)
    layer = 7
    caches = {name: (ck.clone(), cv.clone()) for name in ("old", "new")}

    def old_call():  # the dense-cache forward before the rebuild
        c_k, c_v = caches["old"]
        rows = kv_cache.apply_rope(k, cos, sin)
        _kernels.check(old["vzt_dense_cache_append"](
            c_k.data_ptr(), c_v.data_ptr(), rows.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            layer, 1, 1, T, S, HKV * D * 2, _kernels.stream_ptr(c_k.device)),
            "old vzt_dense_cache_append")

    def new_call():
        c_k, c_v = caches["new"]
        kv_cache.dense_cache_update_rope(c_k, c_v, k, v, cos, sin, lengths, layer)

    old_call()
    new_call()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(caches["old"], caches["new"]))
    if not equal:
        raise AssertionError(f"K2 at T={T}: the old and the new route wrote different caches")
    return {"equal": equal, "old": timed(old_call), "new": timed(new_call)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-dir", required=True,
                    help="a directory holding the earlier paged_kv_rows.cu and "
                         "dense_cache_append.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kv_writer_forms: needs a CUDA card")
    card = card_name()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    _kernels.lib()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        old = build_forms(args.baseline_dir, tmp)
        routes = {"k4_decode": lambda: k4_decode(old, gen),
                  "k4_verify": lambda: k4_verify(old, gen),
                  "k2_decode": lambda: k2(old, gen, 2048, 1, 517),
                  "k2_chunk": lambda: k2(old, gen, 1024, 256, 512)}
        for name, run in routes.items():
            row = results[name] = run()
            print(f"{name}: " + "; ".join(
                f"{form} {t['device_ms']:.4f} ms on the device, issued {t['issue_ms']:.4f}"
                for form, t in row.items() if isinstance(t, dict))
                + f"; outputs equal [{card}]", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
