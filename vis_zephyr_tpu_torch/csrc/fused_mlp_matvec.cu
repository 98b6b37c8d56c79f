// K9 fused_mlp_matvec: a whole decoder MLP on int8 weights in two launches,
// for a few rows of x (decode at small batch):
//
//   g = (x @ Wg.T) * sg          f32 sums, per-row f32 scale
//   u = (x @ Wu.T) * su
//   h = bf16(g * sigmoid(g) * u)                      (never in device memory)
//   y = bf16((h @ Wd.T) * sd)    f32 sums over all of I, one rounding
//
// Replaces the TPU kernel `experiments/fused_mlp_matvec_probe.py::_kernel`
// (:38, wrapper `fused_mlp_matvec`), the same arithmetic: x in bf16, int8 ->
// bf16 exact, products summed in f32, scales applied once per output, h
// rounded to bf16 once, the down sum in f32 over all of I. Port layout, the
// one `QuantLinear` keeps (`models/quant_linear.py`): gate and up int8
// [I, D], down int8 [D, I], each row contiguous along its input, with f32
// scales [I], [I] and [D]. x is [M, D] bf16 with M = 1 .. 8.
//
// What bounds it on the H100: bytes. At M = 1 it reads 3 * D * I int8 weights
// (176.2 MB at D = 4096, I = 14336: 0.0526 ms at 3.35 TB/s) for 2 * 3 * D * I
// operations (0.35 GFLOP), so the weights must stream once at full rate and
// the arithmetic only has to keep up.
//
// What the design does about it:
// - one block per slice of BI rows of I (BI = 64 or 128: 224 or 112 blocks at
//   I = 14336), 8 warps. x is staged once in shared memory. A warp owns a
//   16-row tile of the slice, of the gate and of the up weight together, over
//   all of D (BI = 128) or half of it (BI = 64; the two halves are summed in
//   order through shared memory). Its products go through the tensor cores
//   with the weights as the A operand (mma.sync m16n8k16, bf16 in, f32
//   accumulate) and x transposed as B, its 8 columns the rows of x: M up to 8
//   costs what M = 1 costs. The gate and up sums of a row land in the same
//   lane, so scales, SiLU and the product are applied in registers, and h
//   goes to shared memory in bf16.
// - the weight fragment loads use K5's permutation of K inside each 64-wide
//   chunk (`quant_matmul_int8.cu`): a lane loads 16 contiguous bytes of each of
//   its two rows per chunk, and x (or h) is permuted alike. Four chunks of
//   loads (gate and up, 256 bytes a lane, 64 KB a block) are issued before any
//   of them is used, so many loads are in flight per thread.
// - the down product of the slice: each warp takes 16-row tiles of Wd (the
//   outputs n) over the slice's BI columns, with h's fragments held in
//   registers, and writes the tile's f32 partial sums [blocks, M, D]. Rows of
//   Wd are read as BI-byte runs. Tiles are batched so that 256 bytes a lane
//   are in flight again.
// - a second launch sums the partials of the blocks in block order, scales
//   by sd and rounds: the result does not depend on the schedule. The
//   partials cost 2 * 4 * M * D bytes per block (3.7 MB at M = 1, BI = 128,
//   2 % of the weights; 8 times that at M = 8).
// Left for later: TMA and a persistent schedule, wgmma, a cheaper int8 ->
// bf16 convert.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;   // K per mma group: 4 steps of k16
constexpr int kBatch = 4;    // chunks (phase 1) loaded before use
constexpr int kMaxRows = 8;  // rows of x: the mma's n = 8

// Two int8 bytes of `word` (at bit `shift` and `shift + 8`) as a bf16 pair,
// the first in the low half, as an mma fragment register holds them.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t word, int shift) {
  const float lo = static_cast<float>(static_cast<int8_t>((word >> shift) & 0xffu));
  const float hi = static_cast<float>(static_cast<int8_t>((word >> (shift + 8)) & 0xffu));
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// One 64-wide chunk: A rows g (words ra) and g + 8 (words rb) of a 16-row
// weight tile, B = 16 permuted bf16 of column g (words b, two per k16 step).
__device__ __forceinline__ void mma_chunk(float (&c)[4], const uint4& ra, const uint4& rb,
                                          const uint32_t (&b)[8]) {
  const uint32_t wa[4] = {ra.x, ra.y, ra.z, ra.w};
  const uint32_t wb[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    vzt::mma_m16n8k16_bf16(c, s8x2_to_bf16x2(wa[s], 0), s8x2_to_bf16x2(wb[s], 0), s8x2_to_bf16x2(wa[s], 16),
             s8x2_to_bf16x2(wb[s], 16), b[2 * s], b[2 * s + 1]);
  }
}

__device__ __forceinline__ void words(const unsigned char* p, uint32_t (&w)[8]) {
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 16);
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

struct Params {
  const __nv_bfloat16* x;  // [M, D]
  const int8_t* gate;      // [I, D]
  const float* gate_scale; // [I]
  const int8_t* up;        // [I, D]
  const float* up_scale;   // [I]
  const int8_t* down;      // [D, I]
  float* partial;          // [blocks, M, D]
  int M, D, I;
};

template <int BI>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(const Params p) {
  constexpr int kRowTiles = BI / 16;           // 16-row tiles of the slice
  constexpr int kSplits = kWarps / kRowTiles;  // warps sharing a tile, along D
  constexpr int kHStride = 2 * BI + 16;        // bytes of a shared h row (padded)
  constexpr int kChunksH = BI / kChunk;        // down product's chunks per tile
  constexpr int kTileBatch = 2 * kBatch / kChunksH;  // down tiles loaded before use

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // groupID: A row, B and C column (= row m of x)
  const int t = lane & 3;   // threadID_in_group
  const int M = p.M, D = p.D, I = p.I;
  const int i0 = blockIdx.x * BI;
  const int x_stride = 2 * D + 16;  // bytes of a shared x row (padded)

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* x_s = smem;                            // [M][x_stride]
  unsigned char* h_s = x_s + M * x_stride;              // [8][kHStride] bf16
  float* red = reinterpret_cast<float*>(h_s + kMaxRows * kHStride);  // [kSplits-1][tiles][32][8]

  // x -> shared memory, 16 bytes a thread.
  const int vec_per_row = D / 8;
  for (int idx = threadIdx.x; idx < M * vec_per_row; idx += kThreads) {
    const int m = idx / vec_per_row, c = idx % vec_per_row;
    *reinterpret_cast<uint4*>(x_s + m * x_stride + c * 16) =
        __ldg(reinterpret_cast<const uint4*>(p.x + static_cast<size_t>(m) * D) + c);
  }
  __syncthreads();

  // -- gate and up: rows i0 + tile * 16 + g (+ 8) over this warp's part of D.
  const int tile = warp % kRowTiles;
  const int split = warp / kRowTiles;
  const int chunks = D / kChunk / kSplits;
  const int c_begin = split * chunks;
  const size_t row_a = static_cast<size_t>(i0 + tile * 16 + g) * D;
  const size_t row_b = row_a + static_cast<size_t>(8) * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float acc_g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_u[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = c_begin; c0 < c_begin + chunks; c0 += kBatch) {
    uint4 wg[kBatch][2], wu[kBatch][2];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool ok = c0 + j < c_begin + chunks;
      const size_t k = static_cast<size_t>(c0 + j) * kChunk + 16 * t;
      wg[j][0] = ok ? __ldcs(reinterpret_cast<const uint4*>(p.gate + row_a + k)) : zero;
      wg[j][1] = ok ? __ldcs(reinterpret_cast<const uint4*>(p.gate + row_b + k)) : zero;
      wu[j][0] = ok ? __ldcs(reinterpret_cast<const uint4*>(p.up + row_a + k)) : zero;
      wu[j][1] = ok ? __ldcs(reinterpret_cast<const uint4*>(p.up + row_b + k)) : zero;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j >= c_begin + chunks) break;
      // B: row g of x, its 16 bf16 at k = chunk * 64 + 16t (0 for rows >= M).
      uint32_t b[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (g < M) words(x_s + g * x_stride + ((c0 + j) * kChunk + 16 * t) * 2, b);
      mma_chunk(acc_g, wg[j][0], wg[j][1], b);
      mma_chunk(acc_u, wu[j][0], wu[j][1], b);
    }
  }

  // The splits of a tile are summed in order (split 0 first, then 1, ...).
  if (kSplits > 1) {
    if (split > 0) {
      float* r = red + ((static_cast<size_t>(split - 1) * kRowTiles + tile) * 32 + lane) * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[e] = acc_g[e];
        r[4 + e] = acc_u[e];
      }
    }
    __syncthreads();
    if (split == 0) {
      for (int s = 1; s < kSplits; ++s) {
        const float* r = red + ((static_cast<size_t>(s - 1) * kRowTiles + tile) * 32 + lane) * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_g[e] += r[e];
          acc_u[e] += r[4 + e];
        }
      }
    }
  }
  // C fragment element e: row g + 8 * (e / 2) of the tile, column (row of x)
  // 2t + e % 2. Columns past M hold 0 (their x rows were 0), and so their h.
  if (split == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tile * 16 + g + 8 * (e >> 1);
      const int m = 2 * t + (e & 1);
      const float gv = acc_g[e] * p.gate_scale[i0 + r];
      const float uv = acc_u[e] * p.up_scale[i0 + r];
      const float sig = 1.0f / (1.0f + expf(-gv));
      *reinterpret_cast<__nv_bfloat16*>(h_s + m * kHStride + r * 2) =
          __float2bfloat16_rn(gv * sig * uv);
    }
  }
  __syncthreads();

  // -- down: partial[block][m][n] = sum over the slice of h[m][i] * Wd[n][i].
  uint32_t hb[kChunksH][8];
#pragma unroll
  for (int cc = 0; cc < kChunksH; ++cc) words(h_s + g * kHStride + (cc * kChunk + 16 * t) * 2, hb[cc]);
  const int n_tiles = D / 16;
  float* out = p.partial + static_cast<size_t>(blockIdx.x) * M * D;
  for (int nt0 = warp; nt0 < n_tiles; nt0 += kWarps * kTileBatch) {
    uint4 wa[kTileBatch][kChunksH], wb[kTileBatch][kChunksH];
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      const int nt = nt0 + j * kWarps;
      const bool ok = nt < n_tiles;
      const size_t ra = static_cast<size_t>(ok ? nt * 16 + g : 0) * I + i0 + 16 * t;
      const size_t rb = ra + static_cast<size_t>(8) * I;
#pragma unroll
      for (int cc = 0; cc < kChunksH; ++cc) {
        wa[j][cc] = ok ? __ldcs(reinterpret_cast<const uint4*>(p.down + ra + cc * kChunk)) : zero;
        wb[j][cc] = ok ? __ldcs(reinterpret_cast<const uint4*>(p.down + rb + cc * kChunk)) : zero;
      }
    }
#pragma unroll
    for (int j = 0; j < kTileBatch; ++j) {
      const int nt = nt0 + j * kWarps;
      if (nt >= n_tiles) break;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int cc = 0; cc < kChunksH; ++cc) mma_chunk(acc, wa[j][cc], wb[j][cc], hb[cc]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 2 * t + (e & 1);
        if (m < M) out[static_cast<size_t>(m) * D + nt * 16 + g + 8 * (e >> 1)] = acc[e];
      }
    }
  }
}

// y[m][n] = bf16((sum over blocks, in order, of partial[block][m][n]) * sd[n]).
__global__ void fused_mlp_reduce_kernel(const float* __restrict__ partial,
                                        const float* __restrict__ down_scale,
                                        __nv_bfloat16* __restrict__ y, int M, int D, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = M * D;
  if (i >= total) return;
  float sum = 0.0f;
  for (int b = 0; b < blocks; ++b) sum += partial[static_cast<size_t>(b) * total + i];
  y[i] = __float2bfloat16_rn(sum * down_scale[i % D]);
}

template <int BI>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_kernel<BI>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fused_mlp_kernel<BI><<<p.I / BI, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int BI>
size_t smem_bytes(int M, int D) {
  constexpr int kRowTiles = BI / 16;
  constexpr int kSplits = kWarps / kRowTiles;
  return static_cast<size_t>(M) * (2 * D + 16) + kMaxRows * (2 * BI + 16) +
         static_cast<size_t>(kSplits - 1) * kRowTiles * 32 * 8 * sizeof(float);
}

}  // namespace

// x bf16 [M, D]; gate, up int8 [I, D] with f32 scales [I]; down int8 [D, I]
// with f32 scales [D]; partial f32 [I / block_i, M, D] scratch; y bf16 [M, D].
// M 1 .. 8, D a multiple of 128, block_i 64 or 128 dividing I.
extern "C" int vzt_fused_mlp_matvec(const void* x, const void* gate, const void* gate_scale,
                                    const void* up, const void* up_scale, const void* down,
                                    const void* down_scale, void* partial, void* y, int M, int D,
                                    int I, int block_i, void* stream) {
  if (M < 1 || M > kMaxRows || D < 128 || D % 128 != 0 || (block_i != 64 && block_i != 128) ||
      I < block_i || I % block_i != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.gate = static_cast<const int8_t*>(gate);
  p.gate_scale = static_cast<const float*>(gate_scale);
  p.up = static_cast<const int8_t*>(up);
  p.up_scale = static_cast<const float*>(up_scale);
  p.down = static_cast<const int8_t*>(down);
  p.partial = static_cast<float*>(partial);
  p.M = M;
  p.D = D;
  p.I = I;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = block_i == 64 ? launch<64>(p, smem_bytes<64>(M, D), s)
                                        : launch<128>(p, smem_bytes<128>(M, D), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = M * D;
  fused_mlp_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(down_scale),
      static_cast<__nv_bfloat16*>(y), M, D, I / block_i);
  return static_cast<int>(cudaGetLastError());
}
