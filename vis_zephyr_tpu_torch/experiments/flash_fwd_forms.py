"""K1's design choices, measured: the committed `csrc/flash_fwd.cu` against
forms derived from it by undoing one choice each, every form built as a
library of its own, checked against the port's K1 and timed on the device.

Forms (each a text edit of the committed source):
- `committed`: a three-stage K/V ring, and a producer warpgroup that hands its
  registers to the two consumer warpgroups with setmaxnreg (384 threads);
- `two_stages`: the ring cut to two stages (161 KB of shared memory);
- `producer_warp`: a lone producer warp and no setmaxnreg (288 threads), on
  which ptxas caps a thread at 168 registers, too few for the overlap of
  Q.K^T, softmax and P.V.

    python -m vis_zephyr_tpu_torch.experiments.flash_fwd_forms

Needs the card and nvcc. Prints each form's registers and spills (ptxas),
its largest difference from the port's K1 (the same arithmetic, so 0), and
its device time per call (a CUDA graph of 10 calls, replayed) at causal
B=1, T=S 256 and 2048 and at the trainer's B=8, T=S=2048 with right-padded
keys, on lines that name the card.
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
from ..ops import flash_attention as fa
from .probe_common import card_name, graph_replay_ms

FORMS = {
    "committed": [],
    "two_stages": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "producer_warp": [
        ("constexpr int kThreads = kConsumers + 128;", "constexpr int kThreads = kConsumers + 32;"),
        ("    vzt::setmaxnreg_dec<24>();\n", ""),
        ("  vzt::setmaxnreg_inc<240>();\n", ""),
    ],
}
SHAPES = ((1, 256), (1, 2048), (8, 2048))
LENGTHS = (2048, 1900, 1664, 1537, 1280, 1029, 700, 333)  # chip_smoke.py's B=8 keys
CALLS = 10  # calls in the timed graph


def form_source(edits, source: str = "flash_fwd.cu") -> str:
    """`csrc/<source>` with each (old, new) text edit applied."""
    text = open(os.path.join(_kernels.CSRC, source)).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source} no longer holds {old!r}: update FORMS")
        text = text.replace(old, new)
    return text


def build_libraries(out_dir: str, forms: dict, source: str, entries) -> dict:
    """name -> ({entry: the form's C entry point}, ptxas's `-v` output): each
    form of `csrc/<source>` built as a library of its own, one nvcc process
    a form, all at once."""
    stem = os.path.splitext(source)[0]
    jobs = {}
    for name, edits in forms.items():
        src = os.path.join(out_dir, f"{stem}_{name}.cu")
        with open(src, "w") as f:
            f.write(form_source(edits, source))
        lib = os.path.join(out_dir, f"{stem}_{name}.so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               "-I", _kernels.CSRC, "-o", lib, src]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on form {name}:\n{out}{err}")
        handle = ctypes.CDLL(lib)
        fns = {}
        for entry in entries:
            fn = getattr(handle, entry)
            fn.argtypes = _kernels._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
        built[name] = (fns, out + err)
    return built


def build_forms(out_dir: str) -> dict:
    """name -> (the form's `vzt_flash_fwd`, ptxas registers and spill bytes)."""
    forms = {}
    for name, (fns, log) in build_libraries(out_dir, FORMS, "flash_fwd.cu",
                                            ["vzt_flash_fwd"]).items():
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        forms[name] = (fns["vzt_flash_fwd"], {"registers": int(regs[0]) if regs else None,
                                              "spill_bytes": int(spills[0]) if spills else None})
    return forms


def inputs(B: int, T: int, gen: torch.Generator):
    Hq, Hkv, D = 32, 8, 128
    q = torch.randn(B, T, Hq, D, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, T, Hkv, D, generator=gen, device="cuda").to(torch.bfloat16)
    kv_valid = torch.ones(B, T, dtype=torch.bool, device="cuda")
    if B == len(LENGTHS):
        kv_valid = (torch.arange(T, device="cuda")[None, :]
                    < torch.tensor(LENGTHS, device="cuda")[:, None])
    return q, k, v, kv_valid


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_forms: needs a CUDA card")
    card = card_name()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        forms = build_forms(tmp)
        for name, (_, ptxas) in forms.items():
            print(f"form {name}: ptxas {ptxas}")
        for B, T in SHAPES:
            q, k, v, kv_valid = inputs(B, T, gen)
            scale = q.shape[-1] ** -0.5
            want = fa.flash_attention_fwd(q, k, v, kv_valid, True, scale)
            row = {}
            for name, (launch, _) in forms.items():
                got = (torch.empty_like(q), torch.empty_like(want[1]), torch.empty_like(want[2]))

                def call(launch=launch, got=got):
                    # The current stream, asked at each call: a graph captures on its own.
                    _kernels.check(launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          kv_valid.data_ptr(), *(t.data_ptr() for t in got),
                                          B, T, T, q.shape[2], k.shape[2], 1, scale,
                                          _kernels.stream_ptr(q.device)),
                                   f"vzt_flash_fwd ({name})")

                call()
                torch.cuda.synchronize()
                diff = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))

                def calls(call=call):
                    for _ in range(CALLS):
                        call()

                row[name] = {"device_ms": graph_replay_ms(calls) / CALLS, "max_diff": diff}
            results[f"B{B}_T{T}"] = row
            print(f"flash_fwd forms, causal B={B} T=S={T} Hq=32 Hkv=8 D=128 "
                  f"{'(right-padded keys)' if B == len(LENGTHS) else ''}: "
                  + "; ".join(f"{n} {r['device_ms']:.4f} ms (diff {r['max_diff']:.1e})"
                              for n, r in row.items()) + f" [{card}]")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
