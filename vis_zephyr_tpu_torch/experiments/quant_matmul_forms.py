"""K5's and K6's design choices, measured: the committed mainloop
(`csrc/quant_matmul_common.cuh` with the front ends of
`csrc/quant_matmul_int8.cu` and `csrc/quant_matmul_int4.cu`) against forms
derived from it by undoing one choice each, every form built as libraries of
its own, checked against the plain versions and timed on the device.

Forms (each a text edit of the committed header):
- `committed`: each 16-byte chunk its own wgmma group, one wait a stage, a
  ring of up to 64 KB;
- `group_a_stage`: one wgmma group a stage (its chunks converted between the
  group's first fence and its commit) instead of one a chunk;
- `shallow_ring`: a ring of up to 32 KB (4 stages at every n);
- `plain_wait`: the consumers wait for a stage with `vzt::mbar_wait` (its
  try-wait loop in C++) instead of `vzt::mbar_wait_spin` (the loop in PTX);
and one schedule form, `no_split`: the committed kernels with K never split
(one block a column tile, as many blocks as tiles).

    python -m vis_zephyr_tpu_torch.experiments.quant_matmul_forms

Needs the card and nvcc. Prints each form's ptxas notes, registers and
spills, then for M = 1, 32 and 128 each form's device time per decoder
projection of Zephyr-7B (a CUDA graph of 10 calls, replayed) and summed over
a decoder pass (32 layers of q, k, v, o, gate, up, down), with its largest
per-row error against the plain version, on lines that name the card.
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
from ..ops import quant as quant_ops
from ..ops import quant_matmul as qmm
from .probe_common import card_name, graph_replay_ms

COMMON = "quant_matmul_common.cuh"
SOURCES = {8: "quant_matmul_int8.cu", 4: "quant_matmul_int4.cu"}
_ISSUE = ("            vzt::desc_sw128(st + F::x_box(c, q) * S::kXBox + 32u * F::x_step(c), 16, "
          "1024), 1);\n")
FORMS = {
    "committed": [],
    "group_a_stage": [(_ISSUE + "      vzt::wgmma_commit();\n    }\n",
                       _ISSUE + "    }\n    vzt::wgmma_commit();\n")],
    "shallow_ring": [("constexpr int kRingBytes = 65536;", "constexpr int kRingBytes = 32768;")],
    "plain_wait": [("vzt::mbar_wait_spin(full(s)", "vzt::mbar_wait(full(s)")],
}
# (K, N) of a decoder layer's projections and how many a layer runs.
PASS = {"q, o": (4096, 4096, 2), "k, v": (4096, 1024, 2), "gate, up": (4096, 14336, 2),
        "down": (14336, 4096, 1)}
ROWS = (1, 32, 128)
CALLS = 10  # calls in the timed graph


def form_source(edits) -> str:
    """`csrc/quant_matmul_common.cuh` with each (old, new) text edit applied."""
    text = open(os.path.join(_kernels.CSRC, COMMON)).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{COMMON} no longer holds {old!r}: update FORMS")
        text = text.replace(old, new)
    return text


def ptxas_report(log: str) -> dict:
    """The largest registers and spill bytes over the kernel's instantiations,
    and ptxas's performance notes (C75xx codes), from `-Xptxas -v` output."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
    return {"registers": max(regs) if regs else None, "spill_bytes": max(spills) if spills else None,
            "notes": sorted(set(re.findall(r"\((C75\d\d)\)", log)))}


def build_forms(out_dir: str) -> dict:
    """name -> ({bits: the form's C entry}, {bits: ptxas report}): each form's
    header beside copies of both front ends, one library a (form, bits), one
    nvcc process each, all at once."""
    jobs = {}
    for name, edits in FORMS.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        with open(os.path.join(d, COMMON), "w") as f:
            f.write(form_source(edits))
        for bits, src in SOURCES.items():
            with open(os.path.join(d, src), "w") as f:
                f.write(open(os.path.join(_kernels.CSRC, src)).read())
            lib = os.path.join(d, f"{bits}.so")
            cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                   "-I", _kernels.CSRC, "-o", lib, os.path.join(d, src)]
            jobs[(name, bits)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.PIPE, text=True))
    built = {}
    for (name, bits), (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on form {name} ({bits} bits):\n{out}{err}")
        entry = f"vzt_quant_matmul_int{bits}"
        fn = getattr(ctypes.CDLL(lib), entry)
        fn.argtypes = _kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns, reports = built.setdefault(name, ({}, {}))
        fns[bits], reports[bits] = fn, ptxas_report(out + err)
    return built


def launcher(fn, bits: int, x, w, scale, split: bool):
    """One call of a form's entry on x, with the port's schedule (or, without
    `split`, one split), the output and scratch allocated as the wrapper does."""
    M, K = x.shape
    N = w.shape[0]
    G = scale.shape[1] if bits == 4 else 0
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = qmm.schedule(M, N, K, sms, K // G if bits == 4 else 0)
    splits, per = (plan.splits, plan.per_split) if split else (1, plan.stages)
    counters = _kernels.split_counts(x.device, plan.tiles)

    def call():
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        ws = torch.empty(splits * plan.tiles * plan.block_n * plan.n_rows, dtype=torch.float32,
                         device=x.device)
        args = (x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), ws.data_ptr(),
                counters.data_ptr(), M, N, K) + ((G,) if bits == 4 else ()) + (
                    splits, per, 0, _kernels.stream_ptr(x.device))
        _kernels.check(fn(*args), f"vzt_quant_matmul_int{bits}")
        return out

    return call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("quant_matmul_forms: needs a CUDA card")
    card = card_name()
    gen = torch.Generator("cuda").manual_seed(args.seed)
    weights = {}
    for shape, (K, N, _) in PASS.items():
        w = torch.randn(N, K, generator=gen, device="cuda") * K ** -0.5
        weights[(8, shape)] = quant_ops.quantize_kernel(w)
        weights[(4, shape)] = quant_ops.quantize_kernel_int4(w, 128)
        del w
    plain = {8: qmm.quantized_matmul_plain, 4: qmm.quantized_matmul_int4_plain}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        forms = build_forms(tmp)
        for name, (_, reports) in forms.items():
            print(f"form {name}: ptxas int8 {reports[8]}, int4 {reports[4]}")
        runs = [(name, name, True) for name in forms] + [("no_split", "committed", False)]
        for M in ROWS:
            x = torch.randn(M, 14336, generator=gen, device="cuda").to(torch.bfloat16)
            for label, form, split in runs:
                row = {}
                for bits in (8, 4):
                    per_shape, err, total = {}, 0.0, 0.0
                    for shape, (K, N, n) in PASS.items():
                        xk = x[:, :K].contiguous()
                        w, s = weights[(bits, shape)]
                        call = launcher(forms[form][0][bits], bits, xk, w, s, split)
                        got, want = call().float(), plain[bits](xk, w, s).float()
                        err = max(err, float(((got - want).abs().amax(1)
                                              / want.abs().amax(1).clamp_min(1e-30)).max()))

                        def calls(call=call):
                            for _ in range(CALLS):
                                call()

                        per_shape[shape] = graph_replay_ms(calls) / CALLS
                        total += 32 * n * per_shape[shape]
                    row[bits] = {"pass_ms": total, "by_shape": per_shape, "max_row_err": err}
                results[f"M{M}_{label}"] = row
                print(f"quant_matmul form {label}, M={M}: K5 pass {row[8]['pass_ms']:.3f} ms "
                      f"({', '.join(f'{k} {v:.4f}' for k, v in row[8]['by_shape'].items())}; "
                      f"row err {row[8]['max_row_err']:.1e}), K6 pass {row[4]['pass_ms']:.3f} ms "
                      f"({', '.join(f'{k} {v:.4f}' for k, v in row[4]['by_shape'].items())}; "
                      f"row err {row[4]['max_row_err']:.1e}) [{card}]", flush=True)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
