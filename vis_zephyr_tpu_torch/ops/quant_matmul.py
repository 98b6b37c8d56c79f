"""Weight-only matmuls: the wrappers of kernels K5 (int8,
`csrc/quant_matmul_int8.cu`) and K6 (int4, `csrc/quant_matmul_int4.cu`),
their plain PyTorch versions, the int4 unpacking, and the `qlinear`
dispatch every quantizable projection goes through.

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

`qlinear` routes by M, the rows of x with every leading dim flattened:
M ≤ `QMM_MAX_M` launches K5 (decode steps, short prefill buckets and
chunks, the Q-Former's query rows); above it the weight is dequantized into
x's dtype and multiplied with `torch.matmul`, what the JAX package computes
outside any Pallas kernel (`quant_matmul.py:314`). An int4 projection takes
K6 under `_base_dot`'s gate (M ≤ `QMM_MAX_M`, N and the group multiples of
128) and the dequantize route otherwise (`quant_matmul.py:274-289`). A
tensor on the CPU takes the kernel's plain version; a CUDA tensor launches
the kernel or raises (outside `_kernels.plain_versions()`): a shape a kernel
cannot take inside its gate is an error, never a reason to take the
dequantize route.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import _kernels

QMM_MAX_M = 128      # rows up to which qlinear launches K5 or K6
BLOCK_N = 128        # output columns per K5 / K6 block (8 warps x 2 n-tiles of 8)
CHUNK_K = 64         # K per step of K5's main loop
GROUP_K = 128        # K per step of K6's main loop; K6 takes groups that are multiples of it

launches = 0         # K5 launches in this process (reset by callers that count)
dequant_calls = 0    # int8 qlinear calls above QMM_MAX_M (the dequantize + matmul route)
launches4 = 0        # K6 launches
dequant4_calls = 0   # int4 qlinear calls outside K6's gate (the dequantize + matmul route)


def quantized_matmul_plain(x: torch.Tensor, weight_q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ (weight_q [N, K] · scale [N]).T → [M, N] in x's dtype: f32
    products and sums, the scale applied once at the end."""
    return ((x.float() @ weight_q.float().T) * scale).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def k_splits(M: int, N: int, K: int, sms: int):
    """(splits, 64-wide K chunks per split) for a K5 launch. Splitting K
    gives the narrow-N projections enough blocks for every SM (N = 1024 has
    8 column blocks); each split's f32 partial [M, N] is written and read
    once more, so a split is only taken while that traffic stays within an
    eighth of the weight bytes (K / (16·M) splits)."""
    chunks = K // CHUNK_K
    if chunks == 0:
        return 1, 0
    column_blocks = -(-N // BLOCK_N)
    want = max(1, min(-(-2 * sms // column_blocks), chunks, K // (16 * M)))
    per = -(-chunks // want)
    return -(-chunks // per), per


def _launch(x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
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
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    splits, per = k_splits(M, N, K, _sm_count(dev.index))
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    code = _kernels.lib().vzt_quant_matmul_int8(
        x_ptr, w_ptr, scale.data_ptr(), out.data_ptr(),
        0 if partial is None else partial.data_ptr(), M, N, K, splits, per,
        int(x.dtype == torch.float32), _kernels.stream_ptr(dev))
    _kernels.check(code, "vzt_quant_matmul_int8")
    launches += 1
    return out


def quantized_matmul(x: torch.Tensor, weight_q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(weight_q [N, K] int8, scale [N] f32).T → [M, N] in
    x's dtype (bf16 or f32). K5 on a CUDA tensor, for 1 ≤ M ≤ 128 and K a
    multiple of 16; the plain version on the CPU."""
    if x.dim() != 2 or weight_q.dim() != 2 or weight_q.shape[1] != x.shape[1] \
            or tuple(scale.shape) != (weight_q.shape[0],):
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)}, weight_q "
                         f"{tuple(weight_q.shape)} and scale {tuple(scale.shape)} do not fit")
    if not _kernels.use_kernel(x):
        return quantized_matmul_plain(x, weight_q, scale)
    return _launch(x, weight_q, scale)


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


@functools.lru_cache(maxsize=4096)
def group_splits(M: int, N: int, G: int, sms: int):
    """(splits, groups per split) for a K6 launch: K is split across blocks
    in whole groups, so that no group's scale meets part of its sum, while
    the f32 partials' traffic stays within half the int4 weight bytes (at
    most K / (32·M) splits; the rule K5 keeps for int8)."""
    column_blocks = -(-N // BLOCK_N)
    want = max(1, min(-(-2 * sms // column_blocks), G, (G * GROUP_K) // (32 * M)))
    per = -(-G // want)
    return -(-G // per), per


def _launch4(x: torch.Tensor, weight_q4: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
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
    if N % BLOCK_N or (K // G) % GROUP_K:
        raise ValueError(f"quantized_matmul_int4: K6 takes N and the group in multiples of "
                         f"{GROUP_K}, got N={N}, group={K // G}")
    if weight_q4.device != dev or scale4.device != dev:
        raise ValueError(f"quantized_matmul_int4: weight_q4 and scale4 must be on {dev}")
    if not (weight_q4.is_contiguous() and scale4.is_contiguous()):
        raise ValueError("quantized_matmul_int4: weight_q4 and scale4 must be contiguous")
    xb = x if x.dtype == torch.bfloat16 and x.is_contiguous() else x.to(torch.bfloat16).contiguous()
    x_ptr, w_ptr = xb.data_ptr(), weight_q4.data_ptr()
    if x_ptr % 16 or w_ptr % 16:
        raise ValueError("quantized_matmul_int4: x and weight_q4 must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    splits, per = group_splits(M, N, G, _sm_count(dev.index))
    partial = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    code = _kernels.lib().vzt_quant_matmul_int4(
        x_ptr, w_ptr, scale4.data_ptr(), out.data_ptr(),
        0 if partial is None else partial.data_ptr(), M, N, K, G, splits, per,
        int(x.dtype == torch.float32), _kernels.stream_ptr(dev))
    _kernels.check(code, "vzt_quant_matmul_int4")
    launches4 += 1
    return out


def quantized_matmul_int4(x: torch.Tensor, weight_q4: torch.Tensor,
                          scale4: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant_int4(weight_q4 [N, K/2] int8, scale4 [N, G] f32).T
    → [M, N] in x's dtype (bf16 or f32). K6 on a CUDA tensor, for
    1 ≤ M ≤ 128 and N and the group K / G multiples of 128; the plain
    version on the CPU."""
    if (x.dim() != 2 or scale4.dim() != 2 or x.shape[1] % (2 * scale4.shape[1])
            or tuple(weight_q4.shape) != (scale4.shape[0], x.shape[1] // 2)):
        raise ValueError(f"quantized_matmul_int4: x {tuple(x.shape)}, weight_q4 "
                         f"{tuple(weight_q4.shape)} and scale4 {tuple(scale4.shape)} do not fit")
    if not _kernels.use_kernel(x):
        return quantized_matmul_int4_plain(x, weight_q4, scale4)
    return _launch4(x, weight_q4, scale4)


def _qlinear4(x: torch.Tensor, layer) -> torch.Tensor:
    """The int4 route of `qlinear`: K6 under `_base_dot`'s gate, else the
    weight dequantized into x's dtype and `F.linear`."""
    global dequant4_calls
    weight_q4, scale4 = layer.weight_q4, layer.scale4
    lead, K = x.shape[:-1], x.shape[-1]
    M = math.prod(lead)
    N, G = scale4.shape
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    if M <= QMM_MAX_M and N % BLOCK_N == 0 and (K // G) % GROUP_K == 0:
        out = quantized_matmul_int4(x.reshape(M, K), weight_q4, scale4).reshape(*lead, N)
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
    if M <= QMM_MAX_M:
        out = quantized_matmul(x.reshape(M, K), weight_q, layer.scale).reshape(*lead, -1)
        return out if layer.bias is None else out + layer.bias.to(out.dtype)
    dequant_calls += 1
    return F.linear(x, dequantize(weight_q, layer.scale, x.dtype),
                    None if layer.bias is None else layer.bias.to(x.dtype))
