// K5 quant_matmul_int8: the int8 weight-only matmul,
// out[M, N] = (x[M, K] @ (w[N, K] * scale[N]).T) in x's dtype.
//
// Replaces the TPU kernel `vis_zephyr_tpu/ops/quant_matmul.py::_kernel`
// (wrapper `quantized_matmul`). Same contract, not the same blocks: x in
// bf16, int8 -> bf16 (exact for |v| <= 127), products summed in f32, times
// the per-column f32 scale once at the end, rounded to the output type (bf16
// or f32). Port layout: w is int8 [N, K], row n contiguous along K, which is
// the column-major B operand `mma.sync ... row.col` wants; scale is f32 [N].
// M is 1 to 128 (the wrapper routes larger M to dequantize + matmul), K a
// multiple of 16; M and N are ragged and masked.
//
// What bounds it on the H100: the weight bytes. A decode step at M = 32 does
// 2 * 32 flops per weight byte, far below the 295 the bf16 tensor cores need
// per byte of HBM, so the kernel must stream w once at full rate. CUDA-core
// FMAs would make it compute-bound instead (0.45 TFLOP a step at M = 32), so
// the products go through the tensor cores: mma.sync m16n8k16, bf16 in, f32
// accumulate.
//
// What the design does about it:
// - no shared memory: each thread loads 16 contiguous weight bytes of its
//   row straight into registers (one 16-byte load per row and 64-wide K
//   chunk), and the next chunk's weights are loaded before the current one
//   is multiplied. This needs one permutation of K inside each 64-wide
//   chunk, applied to x and w alike (a sum does not care about order): the
//   lane with threadID_in_group t holds physical k = 16t .. 16t + 15, and
//   mma step s (0..3) takes k = 16t + 4s .. 16t + 4s + 3 as the fragment's
//   logical k = 2t, 2t + 1, 2t + 8, 2t + 9. x's fragment rows are then two
//   16-byte loads per row, served by L1 after the first warp of a block;
// - a block is 8 warps side by side along N, each with 2 n-tiles of 8
//   columns and MT m-tiles of 16 rows (MT = 1, 2, 4 or 8 by M), so a weight
//   fragment is converted once and used for every m-tile;
// - narrow N (k/v at N = 1024 has 8 column blocks) is split over K across
//   blocks (gridDim.y) so that every SM streams weights; each split writes
//   an f32 partial and a second kernel sums the splits in order, scales and
//   rounds, so the result does not depend on the schedule.
// Left for later: TMA / cp.async pipelines, wgmma, a persistent schedule.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps per block, side by side along N
constexpr int kNT = 2;                     // n-tiles of 8 columns per warp
constexpr int kBlockN = kWarps * kNT * 8;  // 128 columns per block
constexpr int kChunk = 64;                 // K per main-loop step

// Two int8 bytes of `word` (at bit `shift` and `shift + 8`) as a bf16 pair,
// the first in the low half, as an mma fragment register holds them.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t word, int shift) {
  const float lo = static_cast<float>(static_cast<int8_t>((word >> shift) & 0xffu));
  const float hi = static_cast<float>(static_cast<int8_t>((word >> (shift + 8)) & 0xffu));
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(void* out, size_t i, float v, bool out_f32) {
  if (out_f32) {
    static_cast<float*>(out)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  }
}

// One block: columns [blockIdx.x * 128, +128) over the K chunks
// [blockIdx.y * chunks_per_split, +chunks_per_split); the last split also
// takes the K % 64 tail in steps of 16. `partial` null: one split, write
// scaled output; else write the split's f32 sums to partial[split][M][N].
template <int MT>
__global__ void __launch_bounds__(kWarps * 32)
    qmm_int8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, void* __restrict__ out,
                    float* __restrict__ partial, int M, int N, int K, int chunks_per_split,
                    bool out_f32) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // groupID: fragment row (A, C) and column (B)
  const int t = lane & 3;   // threadID_in_group
  const int n_warp = blockIdx.x * kBlockN + (threadIdx.x >> 5) * kNT * 8;
  const int n_chunks = K / kChunk;
  const int c_begin = blockIdx.y * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  const int m_tiles = (M + 15) / 16;

  float acc[MT][kNT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // This lane's weight rows (B column g of each n-tile); rows past N read as 0.
  const int8_t* wrow[kNT];
  bool wok[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = n_warp + j * 8 + g;
    wok[j] = n < N;
    wrow[j] = w + static_cast<size_t>(wok[j] ? n : 0) * K;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint4 wcur[kNT], wnext[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    wcur[j] = (wok[j] && c_begin < c_end)
                  ? __ldcs(reinterpret_cast<const uint4*>(wrow[j] + c_begin * kChunk + 16 * t))
                  : zero;
  }
  for (int c = c_begin; c < c_end; ++c) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      wnext[j] = (wok[j] && c + 1 < c_end)
                     ? __ldcs(reinterpret_cast<const uint4*>(wrow[j] + (c + 1) * kChunk + 16 * t))
                     : zero;
    }
    // The chunk's weight fragments, converted once: step s takes word s.
    uint32_t b[kNT][4][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const uint32_t words[4] = {wcur[j].x, wcur[j].y, wcur[j].z, wcur[j].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        b[j][s][0] = s8x2_to_bf16x2(words[s], 0);
        b[j][s][1] = s8x2_to_bf16x2(words[s], 16);
      }
    }
    const int k0 = c * kChunk + 16 * t;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= m_tiles) break;
      // Rows i*16 + g (a0, a2) and i*16 + g + 8 (a1, a3): 16 bf16 each.
      uint4 xr[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = i * 16 + g + 8 * h;
        if (m < M) {
          const uint4* p = reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k0);
          xr[h][0] = __ldg(p);
          xr[h][1] = __ldg(p + 1);
        } else {
          xr[h][0] = zero;
          xr[h][1] = zero;
        }
      }
      const uint32_t lo[8] = {xr[0][0].x, xr[0][0].y, xr[0][0].z, xr[0][0].w,
                              xr[0][1].x, xr[0][1].y, xr[0][1].z, xr[0][1].w};
      const uint32_t hi[8] = {xr[1][0].x, xr[1][0].y, xr[1][0].z, xr[1][0].w,
                              xr[1][1].x, xr[1][1].y, xr[1][1].z, xr[1][1].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_bf16(acc[i][j], lo[2 * s], hi[2 * s], lo[2 * s + 1], hi[2 * s + 1], b[j][s][0],
                   b[j][s][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) wcur[j] = wnext[j];
  }

  // The K % 64 tail, 16 at a time: lane t holds k = k16 + 4t .. k16 + 4t + 3.
  if (blockIdx.y == gridDim.y - 1) {
    for (int k16 = n_chunks * kChunk; k16 < K; k16 += 16) {
      const int k0 = k16 + 4 * t;
      uint32_t b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t word = wok[j] ? __ldg(reinterpret_cast<const unsigned int*>(wrow[j] + k0)) : 0u;
        b[j][0] = s8x2_to_bf16x2(word, 0);
        b[j][1] = s8x2_to_bf16x2(word, 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= m_tiles) break;
        uint2 xr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = i * 16 + g + 8 * h;
          xr[h] = m < M ? __ldg(reinterpret_cast<const uint2*>(x + static_cast<size_t>(m) * K + k0))
                        : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          mma_bf16(acc[i][j], xr[0].x, xr[1].x, xr[0].y, xr[1].y, b[j][0], b[j][1]);
        }
      }
    }
  }

  // C fragment: acc[.][.][2h + e] is row g + 8h, column 2t + e of the tile.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i >= m_tiles) break;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = i * 16 + g + 8 * h;
          const int n = n_warp + j * 8 + 2 * t + e;
          if (m >= M || n >= N) continue;
          const float v = acc[i][j][2 * h + e];
          if (partial != nullptr) {
            partial[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = v;
          } else {
            store(out, static_cast<size_t>(m) * N + n, v * scale[n], out_f32);
          }
        }
      }
    }
  }
}

// out[m][n] = (sum over splits, in order, of partial[split][m][n]) * scale[n].
__global__ void qmm_int8_reduce_kernel(const float* __restrict__ partial,
                                       const float* __restrict__ scale, void* __restrict__ out,
                                       int M, int N, int splits, bool out_f32) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(M) * N;
  if (i >= total) return;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += partial[s * total + i];
  store(out, i, sum * scale[i % N], out_f32);
}

template <int MT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, float* partial,
                   int M, int N, int K, int splits, int chunks_per_split, bool out_f32,
                   cudaStream_t stream) {
  const dim3 grid((N + kBlockN - 1) / kBlockN, splits);
  qmm_int8_kernel<MT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), out, partial, M, N, K, chunks_per_split, out_f32);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K], w int8 [N, K], scale f32 [N], out [M, N] (bf16, or f32 when
// out_f32), partial f32 [splits, M, N] (unused when splits == 1). The splits
// cover ceil(K / 64 / chunks_per_split) ranges of 64-wide K chunks.
extern "C" int vzt_quant_matmul_int8(const void* x, const void* w, const void* scale, void* out,
                                     void* partial, int M, int N, int K, int splits,
                                     int chunks_per_split, int out_f32, void* stream) {
  if (M < 1 || M > 128 || K % 16 != 0 || N < 1 || splits < 1 ||
      (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const bool f32 = out_f32 != 0;
  cudaError_t err;
  if (M <= 16) {
    err = launch<1>(x, w, scale, out, part, M, N, K, splits, chunks_per_split, f32, s);
  } else if (M <= 32) {
    err = launch<2>(x, w, scale, out, part, M, N, K, splits, chunks_per_split, f32, s);
  } else if (M <= 64) {
    err = launch<4>(x, w, scale, out, part, M, N, K, splits, chunks_per_split, f32, s);
  } else {
    err = launch<8>(x, w, scale, out, part, M, N, K, splits, chunks_per_split, f32, s);
  }
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  qmm_int8_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
      part, static_cast<const float*>(scale), out, M, N, splits, f32);
  return static_cast<int>(cudaGetLastError());
}
