"""K7's and K8's design choices, measured: the committed `csrc/flash_bwd.cu`
against forms derived from it by undoing one choice each, every form built
as a library of its own, checked against the port's K7 and K8 and timed on
the device.

Forms (each a text edit of the committed source):
- `committed`: three-stage rings; K7 in two warpgroups and no producer
  warpgroup, on 64-key blocks split over q tiles where its grid of 128-key
  blocks is smaller than the card;
- `dk_waited`: K7 waits for each tile's dK product before the next tile,
  instead of letting it run on beside the next tile's S^T;
- `tid_branch`: K8 takes the warpgroup's role from `tid / 128` as it is,
  which the compiler cannot see to be uniform across a warp;
- `no_split` and `always_split`: K7 on 128-key blocks at every shape, or on
  64-key blocks split over q tiles between the two warpgroups at every
  shape, where the committed rule splits only a grid smaller than the card;
- `four_stages`: both rings deepened to four stages.

    python -m vis_zephyr_tpu_torch.experiments.flash_bwd_forms

Needs the card and nvcc. Prints each form's registers, spills and wgmma
serialization per kernel (ptxas), its largest difference from the port's
K7 and K8 (0 where the form keeps the arithmetic; a form that splits K7's
blocks otherwise adds dK and dV in another order) and each kernel's device
time per call
(a CUDA graph of 10 calls, replayed) at causal B=1, T=S 256 and 2048 and at
the trainer's B=8, T=S=2048 with right-padded keys, on lines that name the
card.
"""

from __future__ import annotations

import argparse
import json
import re
import tempfile

import torch

from ..ops import _kernels
from ..ops import flash_attention as fa
from . import flash_fwd_forms
from .flash_fwd_forms import SHAPES, inputs
from .probe_common import card_name, graph_replay_ms

_SPLIT_RULE = "const bool split = static_cast<long>(Hkv) * B * ((S + 127) / 128) < sms;"
FORMS = {
    "committed": [],
    "dk_waited": [("    vzt::wgmma_commit();\n    held = it;\n",
                   "    vzt::wgmma_commit();\n    vzt::wgmma_wait<0>();\n"
                   "    vzt::fence_regs(dk_acc);\n    release(it);\n")],
    "tid_branch": [("__shfl_sync(0xffffffffu, tid / 128, 0)", "tid / 128")],
    "no_split": [(_SPLIT_RULE, "const bool split = false;")],
    "always_split": [(_SPLIT_RULE, "const bool split = true;")],
    "four_stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
}
KERNELS = {"dkv": "flash_bwd_dkv_kernel", "dq": "flash_bwd_dq_kernel"}
CALLS = 10  # calls in the timed graph


def form_source(edits) -> str:
    return flash_fwd_forms.form_source(edits, "flash_bwd.cu")


def ptxas_report(log: str) -> dict:
    """kernel -> registers, spill bytes and whether ptxas serialized its
    wgmmas, from `-Xptxas -v` output."""
    chunks = log.split("Compiling entry function")[1:]
    report = {}
    for kernel, function in KERNELS.items():
        # The worst of the function's instantiations.
        parts = [c for c in chunks if function in c.split("\n", 1)[0]]
        regs = [int(x) for c in parts for x in re.findall(r"Used (\d+) registers", c)]
        spills = [int(x) for c in parts for x in re.findall(r"(\d+) bytes spill stores", c)]
        report[kernel] = {
            "registers": max(regs) if regs else None,
            "spill_bytes": max(spills) if spills else None,
            "wgmma_serialized": any("wgmma.mma_async instructions are serialized" in line
                                    and function in line for line in log.splitlines())}
    return report


def build_forms(out_dir: str) -> dict:
    """name -> ({kernel: its C entry in the form's library}, ptxas report)."""
    entries = {kernel: f"vzt_flash_bwd_{kernel}" for kernel in KERNELS}
    return {name: ({kernel: fns[entry] for kernel, entry in entries.items()}, ptxas_report(log))
            for name, (fns, log) in flash_fwd_forms.build_libraries(
                out_dir, FORMS, "flash_bwd.cu", list(entries.values())).items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_forms: needs a CUDA card")
    card = card_name()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        forms = build_forms(tmp)
        for name, (_, ptxas) in forms.items():
            print(f"flash_bwd form {name}: ptxas {ptxas}")
        results["ptxas"] = {name: ptxas for name, (_, ptxas) in forms.items()}
        for B, T in SHAPES:
            q, k, v, kv_valid = inputs(B, T, gen)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
            Hq, Hkv = q.shape[2], k.shape[2]
            scale = q.shape[-1] ** -0.5
            o, m, l = fa.flash_attention_fwd(q, k, v, kv_valid, True, scale)
            di = fa.row_dot(o, do)
            rows = (q, k, v, kv_valid, do, m, l, di)
            want = {"dkv": fa.flash_attention_bwd_dkv(*rows, True, scale),
                    "dq": (fa.flash_attention_bwd_dq(*rows, True, scale),)}
            row = {}
            for name, (entries, _) in forms.items():
                for kernel, launch in entries.items():
                    got = tuple(torch.empty_like(w) for w in want[kernel])

                    def call(launch=launch, got=got, kernel=kernel, name=name):
                        # The current stream, asked at each call: a graph captures on its own.
                        _kernels.check(launch(*(t.data_ptr() for t in rows + got),
                                              B, T, T, Hq, Hkv, 1, scale,
                                              _kernels.stream_ptr(q.device)),
                                       f"vzt_flash_bwd_{kernel} ({name})")

                    call()
                    torch.cuda.synchronize()
                    diff = max(float((g.float() - w.float()).abs().max())
                               for g, w in zip(got, want[kernel]))

                    def calls(call=call):
                        for _ in range(CALLS):
                            call()

                    row[f"{name}/{kernel}"] = {"device_ms": graph_replay_ms(calls) / CALLS,
                                               "max_diff": diff}
            results[f"B{B}_T{T}"] = row
            print(f"flash_bwd forms, causal B={B} T=S={T} Hq=32 Hkv=8 D=128 "
                  f"{'(right-padded keys) ' if not bool(kv_valid.all()) else ''}device ms "
                  "(K7 dkv, K8 dq): "
                  + "; ".join(f"{n} {r['device_ms']:.4f} (diff {r['max_diff']:.1e})"
                              for n, r in row.items()) + f" [{card}]")
            del q, k, v, do, o, m, l, di, want
            torch.cuda.empty_cache()
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
