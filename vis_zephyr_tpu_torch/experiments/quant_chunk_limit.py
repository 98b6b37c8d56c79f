"""Where `qlinear`'s chunked kernel route stops winning: a decoder pass of M
rows on int8 (K5) and int4 (K6) weights, the kernel launched on chunks of
128 rows and the rest (`ops/quant_matmul.py::row_chunks` with no limit)
against the dequantize route (the weight dequantized into bf16, then
`F.linear`), which `qlinear` takes above `QMM_CHUNK_MAX_M`.

    python -m vis_zephyr_tpu_torch.experiments.quant_chunk_limit [--rows 160,256,...]

Needs the card. A pass is q, k, v, o, gate, up and down of each of the 32
layers at full width (random codes and scales, each layer's weights its own
tensors), x bf16; its device time is the median replay of one CUDA graph of
the 224 calls. Prints one line per M and weight form, then the largest M at
which the chunks win at every measured M up to it, per form, on lines that
name the card, and returns the times.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from ..config import VisZephyrConfig
from ..ops import quant_matmul as qmm
from .probe_common import card_name, graph_replay_ms

ROWS = (160, 256, 512, 640, 768, 1024, 1152, 1280, 1408, 1536, 2048)


def pass_shapes():
    """(N, K) of a decoder layer's seven projections."""
    dec = VisZephyrConfig().decoder
    D, I, kv = dec.hidden_size, dec.intermediate_size, dec.num_kv_heads * dec.head_dim
    return [(D, D), (kv, D), (kv, D), (D, D), (I, D), (I, D), (D, I)], dec.num_layers


def make_weights(bits: int, gen: torch.Generator):
    """Every layer's (weight, scale) of one form on the card."""
    shapes, layers = pass_shapes()
    out = []
    for _ in range(layers):
        for N, K in shapes:
            if bits == 8:
                w = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                                  dtype=torch.int8)
                s = torch.rand((N,), generator=gen, device="cuda") * 1e-3 + 1e-4
            else:
                w = torch.randint(-128, 128, (N, K // 2), generator=gen, device="cuda",
                                  dtype=torch.int8)
                s = torch.rand((N, K // 128), generator=gen, device="cuda") * 1e-3 + 1e-4
            out.append((w, s))
    return out


def routes(bits: int, weights, xs):
    """(chunked pass, dequantize pass) over the inputs `xs` [M, K] by K."""
    matmul = qmm.quantized_matmul if bits == 8 else qmm.quantized_matmul_int4

    def chunked():
        for w, s in weights:
            x = xs[w.shape[1] * (2 if bits == 4 else 1)]
            qmm._chunked(matmul, x, w, s, qmm.row_chunks(x.shape[0], limit=x.shape[0]))

    def dequant():
        for w, s in weights:
            x = xs[w.shape[1] * (2 if bits == 4 else 1)]
            dense = (qmm.dequantize(w, s, x.dtype) if bits == 8
                     else qmm.dequant_int4(w, s, x.dtype))
            F.linear(x, dense)

    return chunked, dequant


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default=",".join(map(str, ROWS)))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("quant_chunk_limit: needs the card")
    card = card_name()
    rows = [int(m) for m in args.rows.split(",")]
    gen = torch.Generator("cuda").manual_seed(args.seed)
    result = {"card": card, "limit_now": qmm.QMM_CHUNK_MAX_M}
    for bits in (8, 4):
        weights = make_weights(bits, gen)
        times = {}
        for M in rows:
            xs = {K: torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
                  for K in {K for _, K in pass_shapes()[0]}}
            chunked, dequant = routes(bits, weights, xs)
            times[M] = {"chunked_ms": graph_replay_ms(chunked, replays=10),
                        "dequant_ms": graph_replay_ms(dequant, replays=10),
                        "launches": len(weights) * len(qmm.row_chunks(M, limit=M))}
            print(f"quant_chunk_limit int{bits} decoder pass at M={M}: chunked "
                  f"{times[M]['chunked_ms']:.3f} ms ({times[M]['launches']} launches), "
                  f"dequantize route {times[M]['dequant_ms']:.3f} ms on the device [one CUDA "
                  f"graph of the 224 calls, median of 10 replays; {card}]", flush=True)
            del xs
            torch.cuda.empty_cache()
        wins = 0
        for M in rows:
            if times[M]["chunked_ms"] >= times[M]["dequant_ms"]:
                break
            wins = M
        result[f"int{bits}"] = {"times": times, "chunks_win_up_to": wins}
        print(f"quant_chunk_limit int{bits}: the chunks win at every measured M up to {wins} "
              f"[{card}]", flush=True)
        del weights
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
