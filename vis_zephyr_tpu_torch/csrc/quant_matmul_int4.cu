// K6 quant_matmul_int4: the int4 group-scaled weight-only matmul,
// out[M, N] = x[M, K] @ dequant_int4(w[N, K/2], scale4[N, G]).T in x's dtype.
//
// Replaces the TPU kernel `vis_zephyr_tpu/ops/quant_matmul.py::_make_kernel_int4`
// (wrapper `quantized_matmul_int4`). Same contract: x in bf16, each nibble
// sign-extended with int32 shifts and converted to bf16 (exact for |v| <= 7),
// each group's dot summed in f32, times that group's f32 scale (on the dot
// result, the TPU kernel's `total += d * scale`), the groups summed in f32,
// rounded once to the output type (bf16, or f32). Port layout: w is int8
// [N, K/2], row n contiguous along K, two codes a byte in per-group half-split
// order (byte j of group g holds k = g*group + j in its low nibble and
// k = g*group + group/2 + j in its high nibble); scale4 is f32 [N, G]. M is 1 to
// 128, N a multiple of 128 and the group K / G a multiple of 128 (the wrapper
// sends anything else to dequantize + matmul, as the JAX gate does); M is ragged
// and masked.
//
// What bounds it on the H100: the weight bytes, N*K/2 of codes and 4*N*G of
// scales (3.49 GB of codes and 0.22 GB of scales per decoder pass of Zephyr-7B,
// 1.11 ms at 3.35 TB/s). At M = 32 it does 128 flops per byte of codes, under
// the 295 the bf16 tensor cores need, so it must stream w once at full rate;
// the products go through the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) because the nibble unpacking already costs CUDA-core work.
//
// What the design does about it (K5's design, `quant_matmul_int8.cu`, taken
// per 128 of K):
// - no shared memory: each lane loads 16 contiguous bytes of its weight row
//   per 128-wide step straight into registers, the next step's before this
//   one's products. Those 16 bytes hold 16 k's of a group's first half (low
//   nibbles) and the 16 k's group/2 further on (high nibbles): each half is one
//   of K5's 64-wide chunks, under K5's permutation of K applied to x and w
//   alike (lane t holds physical k = 16t .. 16t + 15 of the half; mma step s
//   takes 16t + 4s .. 16t + 4s + 3 as the fragment's logical k = 2t, 2t + 1,
//   2t + 8, 2t + 9), so x's fragment is two 16-byte loads per row and half;
// - a group's sums stay in their own f32 fragment and are folded into the
//   running total with the lane's four scales (columns 2t, 2t + 1 of both
//   n-tiles) at the group's end; the scales are loaded at the group's start;
// - a block is 8 warps side by side along N, each with 2 n-tiles of 8 columns
//   and MT m-tiles of 16 rows (MT = 1, 2, 4 or 8 by M);
// - narrow N (k/v at N = 1024 has 8 column blocks) is split over K across
//   blocks (gridDim.y) in whole groups, so no scale meets part of a group's
//   sum; each split writes an f32 partial and a second kernel sums the splits
//   in order and rounds, so the result does not depend on the schedule.
// Left for later: lop3 / prmt nibble conversion, more bytes in flight, TMA /
// cp.async pipelines, wgmma, a persistent schedule.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps per block, side by side along N
constexpr int kNT = 2;                     // n-tiles of 8 columns per warp
constexpr int kBlockN = kWarps * kNT * 8;  // 128 columns per block
constexpr int kStepK = 128;                // K per main-loop step: 64 bytes of a row

// Nibble `i` (0..7, bits 4i .. 4i + 3) of `word`, sign-extended: byte b's low
// nibble is i = 2b, its high nibble i = 2b + 1.
__device__ __forceinline__ float nibble(uint32_t word, int i) {
  return static_cast<float>(static_cast<int32_t>(word << (28 - 4 * i)) >> 28);
}

// Two floats as a bf16 pair, the first in the low half, as an mma fragment
// register holds them.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
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

// One block: columns [blockIdx.x * 128, +128) over the groups
// [blockIdx.y * groups_per_split, +groups_per_split). `partial` null: one
// split, write the output; else write the split's f32 sums to
// partial[split][M][N].
template <int MT>
__global__ void __launch_bounds__(kWarps * 32)
    qmm_int4_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, void* __restrict__ out,
                    float* __restrict__ partial, int M, int N, int K, int G,
                    int groups_per_split, bool out_f32) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // groupID: fragment row (A, C) and column (B)
  const int t = lane & 3;   // threadID_in_group
  const int n_warp = blockIdx.x * kBlockN + (threadIdx.x >> 5) * kNT * 8;
  const int group = K / G;
  const int steps_per_group = group / kStepK;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(G, g_begin + groups_per_split);
  const int u_begin = g_begin * steps_per_group;
  const int u_end = g_end * steps_per_group;
  const int m_tiles = (M + 15) / 16;

  float acc[MT][kNT][4];
  float d[MT][kNT][4];  // the current group's sums
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = d[i][j][e] = 0.0f;

  // This lane's weight rows (B column g of each n-tile; N is a multiple of 128,
  // so every row exists) and scale rows (C columns 2t and 2t + 1).
  const int8_t* wrow[kNT];
  const float* srow[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    wrow[j] = w + static_cast<size_t>(n_warp + j * 8 + g) * (K / 2) + 16 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) srow[j][e] = scale + static_cast<size_t>(n_warp + j * 8 + 2 * t + e) * G;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint4 wcur[kNT], wnext[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    wcur[j] = u_begin < u_end ? __ldcs(reinterpret_cast<const uint4*>(wrow[j] + u_begin * 64)) : zero;
  }
  float sc[kNT][2];
  for (int u = u_begin; u < u_end; ++u) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      wnext[j] = u + 1 < u_end ? __ldcs(reinterpret_cast<const uint4*>(wrow[j] + (u + 1) * 64)) : zero;
    }
    const int grp = u / steps_per_group;
    const int c = u - grp * steps_per_group;  // which 64 bytes of the group's row
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) sc[j][e] = __ldg(srow[j][e] + grp);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // The half's weight fragments, converted once: step s takes word s, its
      // bytes' low nibbles (half 0) or high nibbles (half 1).
      uint32_t b[kNT][4][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t words[4] = {wcur[j].x, wcur[j].y, wcur[j].z, wcur[j].w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          b[j][s][0] = bf16x2(nibble(words[s], half), nibble(words[s], 2 + half));
          b[j][s][1] = bf16x2(nibble(words[s], 4 + half), nibble(words[s], 6 + half));
        }
      }
      const int k0 = grp * group + half * (group / 2) + c * 64 + 16 * t;
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
            mma_bf16(d[i][j], lo[2 * s], hi[2 * s], lo[2 * s + 1], hi[2 * s + 1], b[j][s][0],
                     b[j][s][1]);
          }
        }
      }
    }
    if (c == steps_per_group - 1) {
      // The group is done: total += d * scale, in f32, and a new group's sums.
      // C fragment: d[.][j][2h + e] is row g + 8h, column 2t + e of n-tile j.
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][j][e] += d[i][j][e] * sc[j][e & 1];
            d[i][j][e] = 0.0f;
          }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) wcur[j] = wnext[j];
  }

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
          if (m >= M) continue;
          const float v = acc[i][j][2 * h + e];
          if (partial != nullptr) {
            partial[(static_cast<size_t>(blockIdx.y) * M + m) * N + n] = v;
          } else {
            store(out, static_cast<size_t>(m) * N + n, v, out_f32);
          }
        }
      }
    }
  }
}

// out[m][n] = the sum over splits, in order, of partial[split][m][n].
__global__ void qmm_int4_reduce_kernel(const float* __restrict__ partial, void* __restrict__ out,
                                       int M, int N, int splits, bool out_f32) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(M) * N;
  if (i >= total) return;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += partial[s * total + i];
  store(out, i, sum, out_f32);
}

template <int MT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, float* partial,
                   int M, int N, int K, int G, int splits, int groups_per_split, bool out_f32,
                   cudaStream_t stream) {
  const dim3 grid(N / kBlockN, splits);
  qmm_int4_kernel<MT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), out, partial, M, N, K, G, groups_per_split, out_f32);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K], w int8 [N, K/2], scale f32 [N, G], out [M, N] (bf16, or f32
// when out_f32), partial f32 [splits, M, N] (unused when splits == 1). The
// splits cover the G groups, groups_per_split at a time.
extern "C" int vzt_quant_matmul_int4(const void* x, const void* w, const void* scale, void* out,
                                     void* partial, int M, int N, int K, int G, int splits,
                                     int groups_per_split, int out_f32, void* stream) {
  if (M < 1 || M > 128 || N < 1 || N % kBlockN != 0 || G < 1 || K % G != 0 ||
      (K / G) % kStepK != 0 || splits < 1 || groups_per_split < 1 ||
      static_cast<long long>(splits) * groups_per_split < G ||
      static_cast<long long>(splits - 1) * groups_per_split >= G ||
      (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const bool f32 = out_f32 != 0;
  cudaError_t err;
  if (M <= 16) {
    err = launch<1>(x, w, scale, out, part, M, N, K, G, splits, groups_per_split, f32, s);
  } else if (M <= 32) {
    err = launch<2>(x, w, scale, out, part, M, N, K, G, splits, groups_per_split, f32, s);
  } else if (M <= 64) {
    err = launch<4>(x, w, scale, out, part, M, N, K, G, splits, groups_per_split, f32, s);
  } else {
    err = launch<8>(x, w, scale, out, part, M, N, K, G, splits, groups_per_split, f32, s);
  }
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int threads = 256;
  qmm_int4_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
      part, out, M, N, splits, f32);
  return static_cast<int>(cudaGetLastError());
}
