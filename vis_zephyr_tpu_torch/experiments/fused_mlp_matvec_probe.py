"""Single-stream decode probe: the whole decoder MLP on int8 weights (gate
and up matvec, SiLU·mul, down matvec) in one hand-written kernel, K9
(`csrc/fused_mlp_matvec.cu`), against the route a `--load-8bit` decoder
layer takes today: K5 for gate and up, `F.silu(g) · u`, K5 for down.

Port of `experiments/fused_mlp_matvec_probe.py` (its Pallas kernel `_kernel`
is the TPU kernel K9 replaces, its `xla_mlp` the loose reference ported as
`dequant_mlp`). What the probe asks: K5 is the largest device item of a
quantized decode step, and the MLP is 176 of the 218 MB of int8 weights a
layer reads; does one kernel that keeps h = silu(g)·u out of device memory
stream those bytes faster than three weight-only matmuls?

The weights keep the port's int8 layout, the one `QuantLinear` holds
(`models/quant_linear.py`): gate and up `weight_q` [I, D], down [D, I], each
with an f32 `scale` per output, so K9 runs on a `--load-8bit` layer's `mlp`
as it is (`quantized_mlp_weights`). `from_probe_arrays` takes the JAX
probe's arrays (`wgu` [D, 2I] gate columns then up columns, `sgu` [1, 2I],
`wd` [I, D], `sd` [1, D]) to this layout.

    python -m vis_zephyr_tpu_torch.experiments.fused_mlp_matvec_probe [--device cpu]

runs the numerics check, then (on the card) times 32 chained calls captured
in one CUDA graph, for K9 at each tiling and for the K5 route, and prints
µs per layer, weight GB/s and the speedup on lines that name the card. On
the CPU (`--device cpu`, small widths with `--hidden` / `--intermediate`)
it runs the check alone: a time is a card's.
"""

from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import _kernels
from .probe_common import agreement, card_name, graph_replay_ms

D, I = 4096, 14336   # Zephyr-7B's hidden and intermediate widths, the probe's shapes
CALLS = 32           # chained layer-equivalents per timed graph, as the probe's scan
MAX_ROWS = 8         # K9's gate: the rows of x are the 8 columns of its mma tile
BLOCK_I = (64, 128)  # K9's tilings: rows of I per block
# 224 blocks of 64 rows beat 112 of 128 at M = 1 on an H100 (0.0879 against
# 0.0953 ms on the device, PERF.md row 14); at M = 8 the two are within 4 %.
DEFAULT_BLOCK_I = 64

launches = 0         # K9 launches in this process (reset by callers that count)
_kernels.register_counters(__name__, "launches")


def fused_mlp_matvec_plain(x, gate_q, gate_scale, up_q, up_scale, down_q, down_scale):
    """K9's arithmetic step by step: x in bf16, f32 products and sums, the
    f32 scales, h = g·sigmoid(g)·u rounded to bf16 once, the down sum in f32,
    its scale, one rounding to bf16. x [M, D] → [M, D] bf16."""
    xf = x.to(torch.bfloat16).float()
    g = (xf @ gate_q.float().T) * gate_scale
    u = (xf @ up_q.float().T) * up_scale
    h = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
    return ((h.float() @ down_q.float().T) * down_scale).to(torch.bfloat16)


def dequant_mlp(x, gate_q, gate_scale, up_q, up_scale, down_q, down_scale):
    """The probe's loose reference (`xla_mlp`): each weight dequantized into
    bf16 (codes and scales cast first), bf16 matmuls, SiLU's sigmoid in f32
    rounded to bf16, every product rounded to bf16."""
    bf = torch.bfloat16
    xb = x.to(bf)
    g = xb @ (gate_q.to(bf) * gate_scale.to(bf)[:, None]).T
    u = xb @ (up_q.to(bf) * up_scale.to(bf)[:, None]).T
    h = g * torch.sigmoid(g.float()).to(bf) * u
    return h @ (down_q.to(bf) * down_scale.to(bf)[:, None]).T


def from_probe_arrays(wgu, sgu, wd, sd) -> Tuple[torch.Tensor, ...]:
    """The JAX probe's weights (numpy or anything `np.asarray` takes: `wgu`
    int8 [D, 2I], `sgu` [1, 2I], `wd` int8 [I, D], `sd` [1, D]) as the
    port's (gate_q, gate_scale, up_q, up_scale, down_q, down_scale) on the
    CPU: gate_q = wgu[:, :I].T, up_q = wgu[:, I:].T, down_q = wd.T."""
    wgu, wd = np.asarray(wgu), np.asarray(wd)
    sgu = np.asarray(sgu, np.float32).reshape(-1)
    sd = np.asarray(sd, np.float32).reshape(-1)
    inter = wgu.shape[1] // 2

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return (t(wgu[:, :inter].T), t(sgu[:inter]), t(wgu[:, inter:].T), t(sgu[inter:]),
            t(wd.T), t(sd))


def quantized_mlp_weights(mlp) -> Tuple[torch.Tensor, ...]:
    """(gate_q, gate_scale, up_q, up_scale, down_q, down_scale) of a decoder
    layer's `mlp` whose projections are `QuantLinear`s (`--load-8bit`): their
    buffers as they are, no copy."""
    return (mlp.gate_proj.weight_q, mlp.gate_proj.scale, mlp.up_proj.weight_q,
            mlp.up_proj.scale, mlp.down_proj.weight_q, mlp.down_proj.scale)


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_mlp_matvec: {name} must be {dtype} {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_mlp_matvec: {name} must be contiguous and 16-byte aligned")


def _launch(x, gate_q, gate_scale, up_q, up_scale, down_q, down_scale, block_i: int):
    global launches
    M, hidden = x.shape
    inter = gate_q.shape[0]
    dev = x.device
    if block_i not in BLOCK_I or inter % block_i or hidden % 128:
        raise ValueError(f"fused_mlp_matvec: K9 takes block_i in {BLOCK_I} dividing I and D a "
                         f"multiple of 128, got block_i={block_i}, I={inter}, D={hidden}")
    xb = x.to(torch.bfloat16).contiguous()
    _check("x", xb, dev, torch.bfloat16, (M, hidden))
    for name, w, shape in (("gate_q", gate_q, (inter, hidden)), ("up_q", up_q, (inter, hidden)),
                           ("down_q", down_q, (hidden, inter))):
        _check(name, w, dev, torch.int8, shape)
    for name, s, n in (("gate_scale", gate_scale, inter), ("up_scale", up_scale, inter),
                       ("down_scale", down_scale, hidden)):
        _check(name, s, dev, torch.float32, (n,))
    partial = torch.empty((inter // block_i, M, hidden), dtype=torch.float32, device=dev)
    out = torch.empty((M, hidden), dtype=torch.bfloat16, device=dev)
    code = _kernels.lib().vzt_fused_mlp_matvec(
        xb.data_ptr(), gate_q.data_ptr(), gate_scale.data_ptr(), up_q.data_ptr(),
        up_scale.data_ptr(), down_q.data_ptr(), down_scale.data_ptr(), partial.data_ptr(),
        out.data_ptr(), M, hidden, inter, block_i, _kernels.stream_ptr(dev))
    _kernels.check(code, "vzt_fused_mlp_matvec")
    launches += 1
    return out


def fused_mlp_matvec(x: torch.Tensor, gate_q: torch.Tensor, gate_scale: torch.Tensor,
                     up_q: torch.Tensor, up_scale: torch.Tensor, down_q: torch.Tensor,
                     down_scale: torch.Tensor, block_i: int = DEFAULT_BLOCK_I) -> torch.Tensor:
    """down(silu(gate(x)) · up(x)) on int8 weights → [M, D] bf16, for x
    [M, D] (any float dtype, taken in bf16) with 1 ≤ M ≤ `MAX_ROWS`; gate_q
    and up_q int8 [I, D], down_q int8 [D, I], scales f32 [I], [I], [D]. K9
    on a CUDA tensor (D a multiple of 128, `block_i` 64 or 128 dividing I);
    its plain version on a CPU tensor. Shapes come from the arguments."""
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"fused_mlp_matvec: x must be [M, D] with 1 <= M <= {MAX_ROWS} "
                         f"(K9's gate), got {tuple(x.shape)}")
    args = (x, gate_q, gate_scale, up_q, up_scale, down_q, down_scale)
    if (gate_q.shape != up_q.shape or gate_q.shape[1] != x.shape[1]
            or tuple(down_q.shape) != (gate_q.shape[1], gate_q.shape[0])):
        raise ValueError(f"fused_mlp_matvec: x {tuple(x.shape)}, gate_q {tuple(gate_q.shape)}, "
                         f"up_q {tuple(up_q.shape)} and down_q {tuple(down_q.shape)} do not fit")
    if not _kernels.use_kernel(x):
        return fused_mlp_matvec_plain(*args)
    return _launch(*args, block_i=block_i)


# -- the probe's run ---------------------------------------------------------------------


def random_weights(hidden: int, inter: int, device, seed: int) -> Tuple[torch.Tensor, ...]:
    """The probe's weights: uniform int8 codes in [-127, 127] and scales of
    2e-4 (as `experiments/fused_mlp_matvec_probe.py::main` makes them), from
    `seed`, in the port's layout."""
    gen = torch.Generator(device).manual_seed(seed)

    def codes(n, k):
        return torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)

    def scales(n):
        return torch.full((n,), 2e-4, dtype=torch.float32, device=device)

    return (codes(inter, hidden), scales(inter), codes(inter, hidden), scales(inter),
            codes(hidden, inter), scales(hidden))


def k5_route(x, gate_q, gate_scale, up_q, up_scale, down_q, down_scale):
    """What `layer.mlp(hn)` runs on a `--load-8bit` layer today: `qlinear`'s
    K5 for gate and up, `F.silu(g) · u` in bf16, K5 for down."""
    from ..ops.quant_matmul import quantized_matmul

    g = quantized_matmul(x, gate_q, gate_scale)
    u = quantized_matmul(x, up_q, up_scale)
    return quantized_matmul(F.silu(g) * u, down_q, down_scale)


def chain(fn, x, calls: int = CALLS):
    """`calls` chained layer-equivalents with the probe's feedback
    y·1e-2 + x·0.5 (it keeps the magnitudes bounded)."""
    for _ in range(calls):
        x = (fn(x) * 1e-2 + x * 0.5).to(torch.bfloat16)
    return x


def graph_us_per_call(fn, x, calls: int = CALLS, replays: int = 20) -> float:
    """Device time of one chained call: `calls` calls in one CUDA graph
    (`graph_replay_ms`), the median replay over `calls`, in µs."""
    return graph_replay_ms(lambda: chain(fn, x, calls), replays) * 1e3 / calls


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hidden", type=int, default=D)
    ap.add_argument("--intermediate", type=int, default=I)
    ap.add_argument("--calls", type=int, default=CALLS)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("fused_mlp_matvec_probe: no CUDA device (use --device cpu for the "
                         "numerics check alone)")
    hidden, inter = args.hidden, args.intermediate
    card = card_name() if on_card else "CPU"
    w = random_weights(hidden, inter, device, args.seed)
    gen = torch.Generator(device).manual_seed(args.seed + 1)
    x = (torch.randn(1, hidden, generator=gen, device=device) * 0.05).to(torch.bfloat16)

    # Numerics (bf16 tolerance: the kernel rounds h once, the loose reference
    # every product).
    y = fused_mlp_matvec(x, *w)
    result = {"card": card, "hidden": hidden, "intermediate": inter,
              "vs_plain": agreement(y, fused_mlp_matvec_plain(x, *w)),
              "vs_dequant": agreement(y, dequant_mlp(x, *w))}
    print(f"fused_mlp_matvec_probe numerics, D={hidden}, I={inter}, M=1: against the plain "
          f"version {result['vs_plain']}, against dequant_mlp {result['vs_dequant']} [{card}]",
          flush=True)
    if not on_card:
        print("fused_mlp_matvec_probe: times are not measured on the CPU")
        return result

    weight_bytes = 3 * hidden * inter
    times = {}
    routes = [(f"fused_bi{bi}", lambda v, bi=bi: fused_mlp_matvec(v, *w, block_i=bi))
              for bi in BLOCK_I]
    routes.append(("k5_route", lambda v: k5_route(v, *w)))
    for tag, fn in routes:
        us = graph_us_per_call(fn, x, args.calls)
        times[tag] = us
        print(f"fused_mlp_matvec_probe {tag}: {us:.2f} us per layer, "
              f"{weight_bytes / us / 1e3:.1f} GB/s of int8 weights ({args.calls} chained calls "
              f"in one CUDA graph, median of 20 replays) [{card}]", flush=True)
    for bi in BLOCK_I:
        print(f"fused_mlp_matvec_probe speedup of K9 (block_i {bi}) over the K5 route: "
              f"{times['k5_route'] / times[f'fused_bi{bi}']:.3f} [{card}]", flush=True)
    result["us_per_layer"] = times
    return result


if __name__ == "__main__":
    main()
