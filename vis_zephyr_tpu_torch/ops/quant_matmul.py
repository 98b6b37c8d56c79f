"""int8 weight-only matmul: the wrapper of kernel K5
(`csrc/quant_matmul_int8.cu`), its plain PyTorch version, and the `qlinear`
dispatch every quantizable projection goes through.

Port of `vis_zephyr_tpu/ops/quant_matmul.py` (`quantized_matmul`, `qdot`'s
`_base_dot`). The port keeps torch's weight layout: `weight_q` int8 [N, K]
and `scale` f32 [N] (the JAX package stores `kernel_q` [K, N] and `scale`
[1, N]). The contract is the TPU kernel's: x cast to bf16, int8 → bf16
(exact), products summed in f32, times the per-column f32 scale once at the
end, rounded to x's dtype.

`qlinear` routes by M, the rows of x with every leading dim flattened:
M ≤ `QMM_MAX_M` launches K5 (decode steps, short prefill buckets and
chunks, the Q-Former's query rows); above it the weight is dequantized into
x's dtype and multiplied with `torch.matmul`, what the JAX package computes
outside any Pallas kernel (`quant_matmul.py:314`). A tensor on the CPU takes
K5's plain version; a CUDA tensor launches K5 or raises (outside
`_kernels.plain_versions()`): a shape K5 cannot take at M ≤ `QMM_MAX_M` is
an error, never a reason to take the dequantize route.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import _kernels

QMM_MAX_M = 128      # rows up to which qlinear launches K5
BLOCK_N = 128        # output columns per K5 block (8 warps x 2 n-tiles of 8)
CHUNK_K = 64         # K per step of K5's main loop

launches = 0         # K5 launches in this process (reset by callers that count)
dequant_calls = 0    # qlinear calls above QMM_MAX_M (the dequantize + matmul route)


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


def qlinear(x: torch.Tensor, layer) -> torch.Tensor:
    """`F.linear` for a float or an int8 projection. `layer` carries `weight`
    (an `nn.Linear`) or `weight_q` and `scale` (`models.quant_linear`), and
    `bias` (None for none)."""
    weight_q = getattr(layer, "weight_q", None)
    if weight_q is None:
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
