"""Weight-only matmuls: the wrappers of kernels K5 (int8,
`csrc/quant_matmul_int8.cu`) and K6 (int4, `csrc/quant_matmul_int4.cu`),
their plain PyTorch versions, their launch schedule, the int4 unpacking,
and the `qlinear` dispatch every quantizable projection goes through.

Port of `vis_zephyr_tpu/ops/quant_matmul.py` (`quantized_matmul`,
`quantized_matmul_int4`, `qdot`'s `_base_dot`) and of `ops/quant.py`'s
`unpack_int4` / `dequant_int4`. The port keeps torch's weight layout, each
the JAX package's array transposed: int8 `weight_q` [N, K] with `scale` f32
[N] (JAX: `kernel_q` [K, N], `scale` [1, N]); int4 `weight_q4` int8
[N, K/2] with `scale4` f32 [N, G] (JAX: `kernel_q4` [K/2, N], `scale4`
[G, N]), two codes a byte in per-group half-split order: byte j of group g
holds k = g·group + j in its low nibble and k = g·group + group/2 + j in its
high nibble.

The contracts are the TPU kernels'. int8: x cast to bf16, int8 → bf16
(exact), products summed in f32, times the per-column f32 scale once at the
end, rounded to x's dtype. int4: nibble → bf16 (exact), each group's dot
summed in f32, times that group's f32 scale, the groups summed in f32,
rounded to x's dtype once.

K5 and K6 are one design (`csrc/quant_matmul_common.cuh`): outᵀ = W · xᵀ on
wgmma, the weight tile its register A operand, converted to bf16 in
registers, and x its B operand in shared memory, the rows of x padded to
n = 8, 16, 32, 64 or 128; weights and x stream through a TMA ring of
128-wide K stages. `schedule` picks the launch: column tiles of 64 W rows
(n ≤ 32) or 128 (n ≥ 64), and K split over blocks where the tiles alone
leave the card idle, in whole groups for int4; the last block of a tile to
finish sums the splits' f32 partials in split order. The splits meet on
per-tile counts in `_kernels.split_counts`, one zeroed int32 buffer per
device, which the kernels leave zeroed.

`qlinear` routes by M, the rows of x with every leading dim flattened:
M ≤ `QMM_MAX_M` launches K5 once (decode steps, short prefill buckets and
chunks, the Q-Former's query rows); up to `QMM_CHUNK_MAX_M` it launches K5
on chunks of `QMM_MAX_M` rows and the rest (`row_chunks`: the speculative
verify steps' S rows a slot, prefill chunks of 256); above it the weight is
dequantized into x's dtype and multiplied with `torch.matmul`, what the JAX
package computes outside any Pallas kernel (`quant_matmul.py:314`). An int4
projection takes K6 the same way under the rest of `_base_dot`'s gate (N a
multiple of `INT4_GATE_N` and the group of `INT4_GATE_GROUP`) and the
dequantize route otherwise (`quant_matmul.py:274-289`). The JAX gate takes
the Pallas kernel up to 128 rows only, a TPU choice: on the card a chunked
pass reads the int8 or int4 weight once a chunk, where the dequantize route
writes and reads a bf16 copy of it, so chunks win until the chunks' weight
reads outweigh the copy (`QMM_CHUNK_MAX_M`, set by
`experiments/quant_chunk_limit.py`). Chunks keep the kernels' contract row
for row, so a chunked pass equals an unchunked kernel pass. The gate's
constants do not move with the kernels' tiles. A tensor on the CPU takes
the kernel's plain version; a CUDA tensor launches the kernel or raises
(outside `_kernels.plain_versions()`): a shape a kernel cannot take inside
its gate is an error, never a reason to take the dequantize route.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from . import _kernels

# The routing gate, the JAX package's (`quant_matmul.py:274-289`), and the
# port's chunked rows above it.
QMM_MAX_M = 128        # rows up to which qlinear launches K5 or K6 once
# Rows up to which it launches them on chunks of QMM_MAX_M rows. A decoder pass
# on the H100 (`experiments/quant_chunk_limit.py`): the chunks win on int8
# weights up to 1408 rows (by 0.7 % there, inside the 1 % spread of repeated
# readings; 3.3 % at 1280) and on int4 up to 1792; both lose at 1536 and 2048.
QMM_CHUNK_MAX_M = 1280
INT4_GATE_N = 128      # K6 takes N ...
INT4_GATE_GROUP = 128  # ... and the group in multiples of these

# K5's and K6's tiles (`csrc/quant_matmul_common.cuh`): they move with the kernels.
STAGE_K = 128                   # K a ring stage covers
X_ROWS = (8, 16, 32, 64, 128)   # wgmma's n: the rows of x rounded up
WG_ROWS = 64                    # W rows (output columns) a consumer warpgroup owns
BLOCKS_PER_SM = {64: 3, 128: 1}  # blocks of 64 and of 128 W rows an SM runs at once

launches = 0         # K5 launches in this process, a chunk each (reset by callers that count)
dequant_calls = 0    # int8 qlinear calls above QMM_CHUNK_MAX_M (the dequantize + matmul route)
launches4 = 0        # K6 launches
dequant4_calls = 0   # int4 qlinear calls outside K6's gate (the dequantize + matmul route)
_kernels.register_counters(__name__, "launches", "dequant_calls", "launches4", "dequant4_calls")


def quantized_matmul_plain(x: torch.Tensor, weight_q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ (weight_q [N, K] · scale [N]).T → [M, N] in x's dtype: f32
    products and sums, the scale applied once at the end."""
    return ((x.float() @ weight_q.float().T) * scale).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A K5 or K6 launch: a grid of (`tiles`, `splits`) blocks. Block
    (tile, split) sums W rows [tile·block_n, +block_n) over the 128-wide K
    stages [split·per_split, +per_split), the last split over what is left."""

    n_rows: int      # x's rows as wgmma's n
    block_n: int     # W rows (output columns) a block owns
    tiles: int
    stages: int      # ceil(K / STAGE_K)
    splits: int
    per_split: int

    def k_ranges(self):
        """[(split, k begin, k end)], in the order in which the last block of
        a tile sums the splits' partials."""
        return [(p, p * self.per_split * STAGE_K,
                 min(self.stages, (p + 1) * self.per_split) * STAGE_K)
                for p in range(self.splits)]


@functools.lru_cache(maxsize=4096)
def schedule(M: int, N: int, K: int, sms: int, group: int = 0) -> Schedule:
    """K5's (`group` 0) or K6's (`group` = K / G) launch for x [M, K] and N
    output columns on a card of `sms` SMs. K is split only where the column
    tiles leave the card's block slots idle, into as many splits as the
    slots hold whole sets of tiles, at most one a stage of K (a group for
    int4: a split covers whole groups). Each split's
    f32 fragments (block_n x n_rows a tile) are written once and read once
    by the tile's last block, mostly in L2."""
    n_rows = next(r for r in X_ROWS if M <= r)
    block_n = WG_ROWS * (2 if n_rows >= 64 else 1)
    tiles = -(-N // block_n)
    stages = -(-K // STAGE_K)
    unit = group // STAGE_K if group else 1   # a split covers whole groups
    slots = sms * BLOCKS_PER_SM[block_n]             # blocks the card runs at once
    splits = max(1, min(stages // unit, slots // tiles))
    per = -(-(stages // unit) // splits) * unit
    return Schedule(n_rows, block_n, tiles, stages, -(-stages // per), per)


def row_chunks(M: int, limit: int = QMM_CHUNK_MAX_M) -> list:
    """The rows of each K5 or K6 launch of a `qlinear` pass of M rows: [M] up
    to `QMM_MAX_M`, chunks of `QMM_MAX_M` and the rest up to `limit`, none
    above it (the dequantize route)."""
    if M > limit:
        return []
    full, rest = divmod(M, QMM_MAX_M)
    return [QMM_MAX_M] * full + ([rest] if rest else [])


def _chunked(matmul, x: torch.Tensor, weight, scale, chunks: list) -> torch.Tensor:
    """x [M, K] through `matmul` (`quantized_matmul` or `_int4`) a chunk of
    rows at a time; on the card each chunk's launch writes its rows of one
    output in place."""
    if len(chunks) == 1:
        return matmul(x, weight, scale)
    if not _kernels.use_kernel(x):
        return torch.cat([matmul(part, weight, scale) for part in x.split(chunks)])
    out = torch.empty((x.shape[0], weight.shape[0]), dtype=x.dtype, device=x.device)
    for part, rows in zip(x.split(chunks), out.split(chunks)):
        matmul(part, weight, scale, out=rows)
    return out


def _launch(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
            out=None) -> torch.Tensor:
    # A decode step calls this 224 times and the step is bound by the host,
    # so each check and allocation here is paid on the step's wall.
    global launches
    M, K = x.shape
    N = weight_q.shape[0]
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantized_matmul: x must be bf16 or f32, got {x.dtype}")
    if weight_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("quantized_matmul: weight_q must be int8 and scale f32")
    if not 1 <= M <= QMM_MAX_M:
        raise ValueError(f"quantized_matmul: K5 takes 1 to {QMM_MAX_M} rows, got {M}")
    if K % 16:
        raise ValueError(f"quantized_matmul: K={K} is not a multiple of 16")
    if weight_q.device != dev or scale.device != dev:
        raise ValueError(f"quantized_matmul: weight_q and scale must be on {dev}")
    if not (weight_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("quantized_matmul: weight_q and scale must be contiguous")
    xb = x if x.dtype == torch.bfloat16 and x.is_contiguous() else x.to(torch.bfloat16).contiguous()
    x_ptr, w_ptr = xb.data_ptr(), weight_q.data_ptr()
    if x_ptr % 16 or w_ptr % 16:
        raise ValueError("quantized_matmul: x and weight_q must be 16-byte aligned")
    if out is None:
        out = torch.empty((M, N), dtype=x.dtype, device=dev)
    plan = schedule(M, N, K, _kernels.sm_count(dev.index))
    ws = counters = 0
    if plan.splits > 1:
        counters = _kernels.split_counts(dev, plan.tiles).data_ptr()
        partials = torch.empty(plan.splits * plan.tiles * plan.block_n * plan.n_rows,
                               dtype=torch.float32, device=dev)
        ws = partials.data_ptr()   # `partials` is held until the launch is queued
    code = _kernels.lib().vzt_quant_matmul_int8(
        x_ptr, w_ptr, scale.data_ptr(), out.data_ptr(), ws, counters, M, N, K,
        plan.splits, plan.per_split, int(x.dtype == torch.float32), _kernels.stream_ptr(dev))
    _kernels.check(code, "vzt_quant_matmul_int8")
    launches += 1
    return out


def quantized_matmul(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor,
                     out=None) -> torch.Tensor:
    """x [M, K] @ dequant(weight_q [N, K] int8, scale [N] f32).T → [M, N] in
    x's dtype (bf16 or f32). K5 on a CUDA tensor, for 1 ≤ M ≤ 128 and K a
    multiple of 16, written into `out` (a contiguous [M, N] of x's dtype)
    when given; the plain version on the CPU."""
    if x.dim() != 2 or weight_q.dim() != 2 or weight_q.shape[1] != x.shape[1] \
            or tuple(scale.shape) != (weight_q.shape[0],):
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)}, weight_q "
                         f"{tuple(weight_q.shape)} and scale {tuple(scale.shape)} do not fit")
    if not _kernels.use_kernel(x):
        return quantized_matmul_plain(x, weight_q, scale)
    return _launch(x, weight_q, scale, out)


def dequantize(weight_q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 [N, K] with scales [N] → a dense [N, K] weight in `dtype`, cast
    before the product as the JAX package's `maybe_dequant` does."""
    return weight_q.to(dtype) * scale.to(dtype)[:, None]


# -- int4 ---------------------------------------------------------------------------


def unpack_int4(packed: torch.Tensor, num_groups: int) -> torch.Tensor:
    """int8 [N, K/2] (half-split groups) → int8 [N, K] in [-7, 7]. Shifts on
    int8 wrap and sign-extend as the JAX package's do: (p << 4) >> 4 is the
    low nibble with its sign, p >> 4 the high one."""
    N, Kh = packed.shape
    p = packed.reshape(N, num_groups, Kh // num_groups)
    return torch.cat([(p << 4) >> 4, p >> 4], dim=-1).reshape(N, 2 * Kh)


def dequant_int4(weight_q4: torch.Tensor, scale4: torch.Tensor, dtype) -> torch.Tensor:
    """int4 [N, K/2] with group scales [N, G] → a dense [N, K] weight in
    `dtype`, codes and scales cast before the product as in the JAX
    package's `dequant_int4`."""
    N, G = scale4.shape
    q = unpack_int4(weight_q4, G).reshape(N, G, -1).to(dtype)
    return (q * scale4.to(dtype)[:, :, None]).reshape(N, -1)


def quantized_matmul_int4_plain(x: torch.Tensor, weight_q4: torch.Tensor,
                                scale4: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant_int4(weight_q4, scale4).T → [M, N] in x's dtype:
    each group's dot in f32, times its f32 scale, the groups summed in f32."""
    M, K = x.shape
    N, G = scale4.shape
    xg = x.float().reshape(M, G, K // G).transpose(0, 1)                 # [G, M, group]
    wg = unpack_int4(weight_q4, G).float().reshape(N, G, K // G).permute(1, 2, 0)  # [G, group, N]
    return (torch.bmm(xg, wg) * scale4.T[:, None, :]).sum(dim=0).to(x.dtype)


def _launch4(x: torch.Tensor, weight_q4: torch.Tensor, scale4: torch.Tensor,
             out=None) -> torch.Tensor:
    global launches4
    M, K = x.shape
    N, G = scale4.shape
    dev = x.device
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantized_matmul_int4: x must be bf16 or f32, got {x.dtype}")
    if weight_q4.dtype != torch.int8 or scale4.dtype != torch.float32:
        raise TypeError("quantized_matmul_int4: weight_q4 must be int8 and scale4 f32")
    if not 1 <= M <= QMM_MAX_M:
        raise ValueError(f"quantized_matmul_int4: K6 takes 1 to {QMM_MAX_M} rows, got {M}")
    if N % INT4_GATE_N or (K // G) % INT4_GATE_GROUP:
        raise ValueError(f"quantized_matmul_int4: K6 takes N and the group in multiples of "
                         f"{INT4_GATE_N} and {INT4_GATE_GROUP}, got N={N}, group={K // G}")
    if weight_q4.device != dev or scale4.device != dev:
        raise ValueError(f"quantized_matmul_int4: weight_q4 and scale4 must be on {dev}")
    if not (weight_q4.is_contiguous() and scale4.is_contiguous()):
        raise ValueError("quantized_matmul_int4: weight_q4 and scale4 must be contiguous")
    xb = x if x.dtype == torch.bfloat16 and x.is_contiguous() else x.to(torch.bfloat16).contiguous()
    x_ptr, w_ptr = xb.data_ptr(), weight_q4.data_ptr()
    if x_ptr % 16 or w_ptr % 16:
        raise ValueError("quantized_matmul_int4: x and weight_q4 must be 16-byte aligned")
    if out is None:
        out = torch.empty((M, N), dtype=x.dtype, device=dev)
    plan = schedule(M, N, K, _kernels.sm_count(dev.index), K // G)
    ws = counters = 0
    if plan.splits > 1:
        counters = _kernels.split_counts(dev, plan.tiles).data_ptr()
        partials = torch.empty(plan.splits * plan.tiles * plan.block_n * plan.n_rows,
                               dtype=torch.float32, device=dev)
        ws = partials.data_ptr()   # `partials` is held until the launch is queued
    code = _kernels.lib().vzt_quant_matmul_int4(
        x_ptr, w_ptr, scale4.data_ptr(), out.data_ptr(), ws, counters, M, N, K, G,
        plan.splits, plan.per_split, int(x.dtype == torch.float32), _kernels.stream_ptr(dev))
    _kernels.check(code, "vzt_quant_matmul_int4")
    launches4 += 1
    return out


def quantized_matmul_int4(x: torch.Tensor, weight_q4: torch.Tensor, scale4: torch.Tensor,
                          out=None) -> torch.Tensor:
    """x [M, K] @ dequant_int4(weight_q4 [N, K/2] int8, scale4 [N, G] f32).T
    → [M, N] in x's dtype (bf16 or f32). K6 on a CUDA tensor, for
    1 ≤ M ≤ 128 and N and the group K / G multiples of 128, written into
    `out` when given; the plain version on the CPU."""
    if (x.dim() != 2 or scale4.dim() != 2 or x.shape[1] % (2 * scale4.shape[1])
            or tuple(weight_q4.shape) != (scale4.shape[0], x.shape[1] // 2)):
        raise ValueError(f"quantized_matmul_int4: x {tuple(x.shape)}, weight_q4 "
                         f"{tuple(weight_q4.shape)} and scale4 {tuple(scale4.shape)} do not fit")
    if not _kernels.use_kernel(x):
        return quantized_matmul_int4_plain(x, weight_q4, scale4)
    return _launch4(x, weight_q4, scale4, out)


def _qlinear4(x: torch.Tensor, layer) -> torch.Tensor:
    """The int4 route of `qlinear`: K6 (on `row_chunks`) under the rest of
    `_base_dot`'s gate, else the weight dequantized into x's dtype and
    `F.linear`."""
    global dequant4_calls
    weight_q4, scale4 = layer.weight_q4, layer.scale4
    lead, K = x.shape[:-1], x.shape[-1]
    M = math.prod(lead)
    N, G = scale4.shape
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    chunks = row_chunks(M)
    if chunks and N % INT4_GATE_N == 0 and (K // G) % INT4_GATE_GROUP == 0:
        out = _chunked(quantized_matmul_int4, x.reshape(M, K), weight_q4, scale4,
                       chunks).reshape(*lead, N)
        return out if bias is None else out + bias
    dequant4_calls += 1
    return F.linear(x, dequant_int4(weight_q4, scale4, x.dtype), bias)


def qlinear(x: torch.Tensor, layer) -> torch.Tensor:
    """`F.linear` for a float, an int8 or an int4 projection. `layer` carries
    `weight` (an `nn.Linear`), `weight_q` and `scale`, or `weight_q4` and
    `scale4` (`models.quant_linear`), and `bias` (None for none)."""
    # int8 is looked up first: on an nn.Module a missing name costs a raised
    # AttributeError, and the int8 step makes 224 calls.
    weight_q = getattr(layer, "weight_q", None)
    if weight_q is None:
        if getattr(layer, "weight_q4", None) is not None:
            return _qlinear4(x, layer)
        return F.linear(x, layer.weight, layer.bias)
    global dequant_calls
    lead, K = x.shape[:-1], x.shape[-1]
    M = math.prod(lead)
    chunks = row_chunks(M)
    if chunks:
        out = _chunked(quantized_matmul, x.reshape(M, K), weight_q, layer.scale,
                       chunks).reshape(*lead, -1)
        return out if layer.bias is None else out + layer.bias.to(out.dtype)
    dequant_calls += 1
    return F.linear(x, dequantize(weight_q, layer.scale, x.dtype),
                    None if layer.bias is None else layer.bias.to(x.dtype))
