"""K3's design choices, measured: the committed kernel
(`csrc/paged_attn_decode.cu`) against forms derived from it by undoing one
choice each, every form built as a library of its own, checked against the
plain version and timed on the device.

Forms of the source (text edits of the committed file):
- `committed`: int8 blocks of 16 query rows (decode) with a ring of two
  pages, three to an SM; of 32 rows three pages, two to an SM;
- `three_stages`: every int8 block a ring of three pages, two to an SM
  (the split plan told so);
- `loads_only` (a floor, not a kernel: its output is not checked): the
  warps wait for each stage and free it without computing, so its time is
  the copies', the prologue's and the epilogue's;
- `timeline` (a probe, not timed): the committed kernel with thread 0 of
  each block writing SM clock stamps (block start, barriers set, Q and the
  self-term ready, each stage's arrival and the end of its products, the
  partials in shared memory, the end) and the global timer at its start
  and end into the
  scratch; printed as medians over the blocks and the slowest block's
  breakdown, at the shapes that run one split;
schedule forms of the committed kernel (the split plan told that an SM
holds 6 or 12 blocks, so it splits more): `split_x6`, `split_x12`; and,
with `--baseline FILE`, `baseline`: an earlier K3 source with the C entry
of its PR 12 form (`vzt_paged_attn_decode` without scratch or split
arguments), built and timed in the same call.

    python -m vis_zephyr_tpu_torch.experiments.paged_attn_forms [--baseline FILE]

Needs the card and nvcc. Prints each form's ptxas registers and spills,
then at each shape (int8 KV-fused pools, Hq 32, Hkv 8, D 128, pages of 128,
tables of 16 pages: 32 slots of 60 to 800 tokens with the self-term, the
served decode step's call; the same at 2048 tokens; 32 slots at S = 5 rows
without it, the verify step's; 128 slots of 640 tokens; one slot of 2048)
each form's device time (a CUDA graph of 10 calls, replayed), its worst
per-slot error against the plain version and the bound, on lines that name
the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import tempfile

import torch

from ..ops import _kernels
from ..ops import paged_attention as pa
from .probe_common import card_name, graph_replay_ms

SOURCE = "paged_attn_decode.cu"
FORMS = {
    "committed": [],
    "three_stages": [("static constexpr int kStages = kQuant && MT == 2 ? 3 : 2;",
                      "static constexpr int kStages = kQuant ? 3 : 2;"),
                     ("static constexpr int kBlocksPerSm = kQuant ? (MT == 1 ? 3 : 2) : 1;",
                      "static constexpr int kBlocksPerSm = kQuant ? 2 : 1;")],
    "loads_only": [("      if (key0 < n_tok) {\n        const int pos0",
                    "      if (key0 < n_tok && p.scale < 0.0f) {\n        const int pos0")],
}
BLOCKS_PER_SM = {"three_stages": 2}  # what the split plan assumes for a source form
SCHEDULES = {"split_x6": 6, "split_x12": 12}  # schedule forms of the committed source
_CLK = "static_cast<float>(clock64() - t_start)"
_GT = ("{ unsigned long long gt; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt)); "
       "VZT_STAMP(SLOT, __int_as_float(static_cast<int>(gt & 0x7fffffffull))); }\n")
FORMS["timeline"] = [
    ("template <typename KV, int MT>\n__global__",
     "#define VZT_STAMP(k, v) \\\n  if (tid == 0) p.ws_o[static_cast<long>(blockIdx.x) * 32 + (k)] = (v)\n"
     "template <typename KV, int MT>\n__global__"),
    ("  const int lane = tid & 31;\n",
     "  const int lane = tid & 31;\n  const long long t_start = clock64();\n" + _GT.replace("SLOT", "0")),
    ("    vzt::tma_prefetch(&tm_v);\n  }\n  __syncthreads();\n",
     f"    vzt::tma_prefetch(&tm_v);\n  }}\n  __syncthreads();\n  VZT_STAMP(1, {_CLK});\n"),
    ("= dot[m][hr];\n      }\n  }\n  __syncthreads();\n",
     f"= dot[m][hr];\n      }}\n  }}\n  __syncthreads();\n  VZT_STAMP(2, {_CLK});\n"),
    ("      vzt::mbar_wait_spin(full(s), (i / ST) & 1);\n",
     f"      vzt::mbar_wait_spin(full(s), (i / ST) & 1);\n      if (i < 12) VZT_STAMP(3 + 2 * i, {_CLK});\n"),
    ("      __syncwarp();\n      if (lane == 0) vzt::mbar_arrive(empty(s));\n",
     f"      if (i < 12) VZT_STAMP(4 + 2 * i, {_CLK});\n"
     "      __syncwarp();\n      if (lane == 0) vzt::mbar_arrive(empty(s));\n"),
    ("  // The warps' partials into shared memory",
     f"  VZT_STAMP(27, static_cast<float>(i));\n  VZT_STAMP(28, {_CLK});\n"
     "  // The warps' partials into shared memory"),
    ("      finish(tr, M, L, O);\n    }\n    return;\n",
     "      finish(tr, M, L, O);\n    }\n"
     f"    VZT_STAMP(31, {_CLK});\n" + _GT.replace("SLOT", "30") + "    return;\n"),
]
UNCHECKED = ("loads_only", "timeline")
OLD_SIGNATURE = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
HBM_BYTES_PER_S = 3.35e12   # one H100 SXM at 700 W (NVIDIA's data sheet)
BF16_FLOPS = 989e12
HQ, HKV, D, PS, PPS = 32, 8, 128, 128, 16
CALLS = 10  # calls in the timed graph


def form_source(edits) -> str:
    """`csrc/paged_attn_decode.cu` with each (old, new) text edit applied."""
    text = open(os.path.join(_kernels.CSRC, SOURCE)).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{SOURCE} no longer holds {old!r}: update FORMS")
        text = text.replace(old, new)
    return text


def ptxas_report(log: str) -> dict:
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    return {"registers": max(regs) if regs else None,
            "spill_bytes": max(spills) if spills else None}


def build_forms(out_dir: str, baseline=None) -> dict:
    """name -> (the form's C entry, ptxas report): one library a form, one
    nvcc process each, all at once."""
    jobs = {}
    sources = {name: form_source(edits) for name, edits in FORMS.items()}
    if baseline:
        sources["baseline"] = open(baseline).read()
    for name, text in sources.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        src = os.path.join(d, SOURCE)
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(d, "form.so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               "-I", _kernels.CSRC, "-o", lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on form {name}:\n{out}{err}")
        fn = ctypes.CDLL(lib).vzt_paged_attn_decode
        fn.argtypes = OLD_SIGNATURE if name == "baseline" else _kernels._SIGNATURES[
            "vzt_paged_attn_decode"]
        fn.restype = ctypes.c_int
        built[name] = (fn, ptxas_report(out + err))
    return built


def make_case(gen, lengths, S: int, selfterm: bool) -> dict:
    """int8 KV-fused pools of one layer, every slot 16 pages of its own (a
    shuffled table; page 0 is the trash page), q [B, S, HQ, D] and the
    self-term's rows."""
    B = len(lengths)
    P = B * PPS + 1
    table = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * PPS] + 1).reshape(B, PPS)
    k = torch.randn((P, HKV, 2 * PS, D), generator=gen, device="cuda").to(torch.bfloat16)
    kp, ksc = pa.quantize_kv_pool(k)
    del k
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q = torch.randn((B, S, HQ, D), generator=gen, device="cuda").to(torch.bfloat16)
    new = [torch.randn((B, HKV, D), generator=gen, device="cuda").to(torch.bfloat16)
           for _ in range(2)] if selfterm else [None, None]
    return dict(q=q, kp=kp, ksc=ksc, table=table.to(torch.int32).contiguous(), lengths=lens,
                q_offs=(lens if selfterm else lens - S).contiguous(), k_new=new[0],
                v_new=new[1])


def bound_ms(case) -> float:
    """Each valid K and V row read once with its scale, q, the self-term, the
    table and lengths once, the output written once; against 4·Hq·D flops per
    (query row, key) pair the causal mask keeps."""
    lens = case["lengths"].tolist()
    S = case["q"].shape[1]
    n_bytes = (sum(lens) * HKV * 2 * (D + 4) + 2 * 2 * case["q"].numel()
               + (2 * 2 * case["k_new"].numel() if case["k_new"] is not None else 0)
               + 4 * case["table"].numel() + 8 * len(lens))
    pairs = sum(S * (n - S) + S * (S + 1) // 2 for n in lens) if case["k_new"] is None else (
        sum(lens) + len(lens))
    return max(n_bytes / HBM_BYTES_PER_S, 4 * HQ * D * pairs / BF16_FLOPS) * 1e3


def launcher(fn, case, per_sm=None, old: bool = False):
    """One call of a form's entry, its scratch allocated as the wrapper does."""
    q, kp = case["q"], case["kp"]
    B, S, _, _ = q.shape
    N = kp.shape[0]
    dev = q.device
    plan = pa.split_plan(B, HKV, S * HQ // HKV, PPS, _kernels.sm_count(dev.index), True, per_sm)
    units = B * HKV * plan.tiles
    counters = _kernels.split_counts(dev, units)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def call():
        out = torch.empty_like(q)
        head = (q.data_ptr(), out.data_ptr(), kp.data_ptr(), None, case["ksc"].data_ptr(), None,
                case["table"].data_ptr(), case["lengths"].data_ptr(), case["q_offs"].data_ptr(),
                ptr(case["k_new"]), ptr(case["v_new"]))
        if old:
            code = fn(*head, B, S, HQ, HKV, PS, PPS, 0, 0, 1, D ** -0.5, _kernels.stream_ptr(dev))
        else:
            ws_o = torch.empty(units * plan.splits * plan.tile_rows * D, dtype=torch.float32,
                               device=dev)
            ws_ml = torch.empty(units * plan.splits * plan.tile_rows * 2, dtype=torch.float32,
                                device=dev)
            code = fn(*head, ws_o.data_ptr(), ws_ml.data_ptr(), counters.data_ptr(), B, S, HQ,
                      HKV, N, PS, PPS, 0, 0, 1, plan.tile_rows, plan.splits, D ** -0.5,
                      _kernels.stream_ptr(dev))
        _kernels.check(code, "vzt_paged_attn_decode")
        return out

    return call, plan


def timeline(fn, case) -> dict:
    """One launch of the `timeline` form: each block's stamps (SM cycles
    since its start; the global timer's low bits at its start and end, ns),
    summarized in µs at the clock the stamps show."""
    q, kp = case["q"], case["kp"]
    B, S, _, _ = q.shape
    dev = q.device
    plan = pa.split_plan(B, HKV, S * HQ // HKV, PPS, _kernels.sm_count(dev.index))
    blocks = B * HKV * plan.tiles
    stamps = torch.zeros(blocks * 32, dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    code = fn(q.data_ptr(), out.data_ptr(), kp.data_ptr(), None, case["ksc"].data_ptr(), None,
              case["table"].data_ptr(), case["lengths"].data_ptr(), case["q_offs"].data_ptr(),
              None if case["k_new"] is None else case["k_new"].data_ptr(),
              None if case["v_new"] is None else case["v_new"].data_ptr(), stamps.data_ptr(),
              None, None, B, S, HQ, HKV, kp.shape[0], PS, PPS, 0, 0, 1, plan.tile_rows, 1,
              D ** -0.5, _kernels.stream_ptr(dev))
    _kernels.check(code, "vzt_paged_attn_decode")
    torch.cuda.synchronize()
    st = stamps.view(blocks, 32).cpu()
    gt = st.view(torch.int32)[:, [0, 30]].double()
    ns = (gt[:, 1] - gt[:, 0]) % 2 ** 31
    ghz = float((st[:, 31].double() / ns).median())  # cycles per ns
    us = st.double() / ghz / 1e3
    stages = st[:, 27].round().long()
    waits, works = [], []
    for blk in range(blocks):
        prev = us[blk, 2]
        for i in range(min(int(stages[blk]), 12)):
            waits.append(float(us[blk, 3 + 2 * i] - prev))
            works.append(float(us[blk, 4 + 2 * i] - us[blk, 3 + 2 * i]))
            prev = us[blk, 4 + 2 * i]
    med = lambda xs: float(torch.tensor(xs, dtype=torch.float64).median()) if len(xs) else 0.0
    slow = int(us[:, 31].argmax())
    start = (gt[:, 0] - gt[:, 0].min()) % 2 ** 31 / 1e3
    return {"clock_ghz": ghz, "blocks": blocks, "span_us": float((start + ns / 1e3).max()),
            "latest_start_us": float(start.max()),
            "median_us": {"barriers": med(us[:, 1].tolist()), "q_and_self": med((us[:, 2] - us[:, 1]).tolist()),
                          "stage_wait": med(waits), "stage_work": med(works),
                          "epilogue": med((us[:, 31] - us[:, 28]).tolist()), "block": med(us[:, 31].tolist())},
            "slowest": {"stages": int(stages[slow]), "block_us": float(us[slow, 31]),
                        "start_us": float(start[slow]),
                        "stage_us": [round(float(us[slow, 4 + 2 * i] - us[slow, 3 + 2 * i]), 3)
                                     for i in range(min(int(stages[slow]), 12))]}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="an earlier paged_attn_decode.cu with the PR 12 C entry")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("paged_attn_forms: needs a CUDA card")
    card = card_name()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    served = torch.randint(60, 801, (32,), generator=gen, device="cuda").tolist()
    shapes = {"decode, 32 slots of 60-800": (served, 1, True),
              "decode, 32 slots of 2048": ([2048] * 32, 1, True),
              "verify S=5, 32 slots of 60-800": (served, 5, False),
              "decode, 128 slots of 640": ([640] * 128, 1, True),
              "decode, 1 slot of 2048": ([2048], 1, True)}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        forms = build_forms(tmp, args.baseline)
        for name, (_, report) in forms.items():
            print(f"form {name}: ptxas {report}", flush=True)
        runs = [(name, name, BLOCKS_PER_SM.get(name)) for name in forms if name != "timeline"]
        runs += [(label, "committed", n) for label, n in SCHEDULES.items()]
        for shape, (lengths, S, selfterm) in shapes.items():
            case = make_case(gen, lengths, S, selfterm)
            want = pa.paged_attention_fa_plain(
                case["q"], case["kp"], None, case["table"], case["lengths"], case["q_offs"],
                D ** -0.5, k_scales=case["ksc"], k_new=case["k_new"], v_new=case["v_new"]).float()
            top = want.flatten(1).abs().amax(1).clamp_min(1e-30)
            row = {"bound_ms": bound_ms(case)}
            for label, form, blocks in runs:
                call, plan = launcher(forms[form][0], case, blocks, old=form == "baseline")
                got = call().float()
                err = float(((got - want).flatten(1).abs().amax(1) / top).max())
                if form not in UNCHECKED and not err <= 1e-2:
                    raise AssertionError(f"form {label} at {shape}: per-slot error {err:.3e}")

                def calls(call=call):
                    for _ in range(CALLS):
                        call()

                ms = graph_replay_ms(calls) / CALLS
                row[label] = {"ms": ms, "rel_err": err, "splits": plan.splits}
                print(f"K3 form {label}, {shape}: {ms:.4f} ms on the device ({plan.splits} "
                      f"splits), per-slot error {err:.2e}; bound {row['bound_ms']:.5f} ms [{card}]",
                      flush=True)
            if pa.split_plan(len(lengths), HKV, S * HQ // HKV, PPS,
                             _kernels.sm_count(None)).splits == 1:
                row["timeline"] = timeline(forms["timeline"][0], case)
                print(f"K3 timeline, {shape}: {json.dumps(row['timeline'])} [{card}]", flush=True)
            results[shape] = row
            del case
            torch.cuda.empty_cache()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
