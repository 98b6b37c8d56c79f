// K1 flash_fwd: blockwise online-softmax attention forward (bf16 in/out).
//
// Replaces the TPU kernel `vis_zephyr_tpu/ops/flash_attention.py::_fwd_kernel`
// (grid and block specs in `_flash_forward`). Same contract: q [B,T,Hq,D],
// k/v [B,S,Hkv,D] (the public layout, read in place through strides), kv_valid
// [B,S] bool, causal masking on row indices (col <= row) with whole-tile
// skipping, GQA (q head h reads kv head h / (Hq/Hkv)), f32 online softmax and
// accumulation, a row with no valid key writes 0, and the per-row softmax
// residuals m and l (f32, [B,Hq,T]) for a later backward kernel.
//
// What bounds it on the H100: arithmetic. Per (64-row, 64-column) tile the
// block does 2 * 64*64*128 multiply-adds and reads 16 KB of K and 16 KB of V,
// so attention at T=2048 is far above the card's bytes-per-operation line. This
// first version runs the products on the CUDA cores in f32 (plain FMA), not on
// the tensor cores, so it is bounded by FMA issue and shared-memory reads, well
// below the bf16 tensor-core peak: 21.0 TFLOP/s at T=S=2048, Hq=32 (H100 80GB
// HBM3 at 700 W, PERF.md). mma.sync/wgmma, TMA and a K/V pipeline are later work.
//
// What the design does about it:
// - One block per (64-row q tile, q head, batch row); the loop over 64-column
//   K/V tiles inside the block takes the place of the TPU's sequential grid
//   axis, so m, l and the output accumulator live in registers for the whole
//   row tile and never touch device memory.
// - 256 threads; thread (tr, tc) = (tid / 16, tid % 16) owns q rows
//   4*tr .. 4*tr+3. For the score tile it owns columns tc + 16*j; for the
//   output it owns head-dim pairs 2*tc + 32*j. The 16 lanes that share a row
//   sit in one half-warp, so row max and row sum are 4 xor-shuffles.
// - Q, then K, then V tiles are staged in shared memory with 16-byte global
//   loads. K and V share one buffer (K is dead once the scores exist), which
//   keeps static shared memory at 42 KB, under the 48 KB static limit. Rows are
//   padded to 132 bf16 (66 words) so the 16 lanes reading 16 different K rows
//   hit 16 different banks.
// - P is rounded to bf16 before the P.V product, as the TPU kernel does
//   (`p.astype(v.dtype)`), while l sums the f32 probabilities.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kHeadDim = 128;
constexpr int kRowStride = kHeadDim + 4;  // bf16 elements per shared row (264 B)
constexpr int kThreads = 256;
constexpr float kNegInf = -0.7f * FLT_MAX;  // the TPU kernel's NEG_INF

// Copies a [64, 128] bf16 tile whose rows are `row_stride` elements apart in
// global memory into a padded shared tile: 16-byte loads, two 8-byte stores.
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kRowStride],
                                          const __nv_bfloat16* src,
                                          long row_stride) {
  constexpr int kVecPerRow = kHeadDim / 8;  // uint4 per row
  for (int idx = threadIdx.x; idx < kBlockK * kVecPerRow; idx += kThreads) {
    const int row = idx / kVecPerRow;
    const int col = (idx % kVecPerRow) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(src + row * row_stride + col);
    uint2* out = reinterpret_cast<uint2*>(&dst[row][col]);
    out[0] = make_uint2(val.x, val.y);
    out[1] = make_uint2(val.z, val.w);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ kv_valid,
                 __nv_bfloat16* __restrict__ out,
                 float* __restrict__ m_out,
                 float* __restrict__ l_out,
                 int T, int S, int Hq, int Hkv, int causal, float scale) {
  __shared__ __align__(16) __nv_bfloat16 q_s[kBlockQ][kRowStride];
  __shared__ __align__(16) __nv_bfloat16 kv_s[kBlockK][kRowStride];
  __shared__ __align__(16) __nv_bfloat16 p_s[kBlockQ][kBlockK + 2];
  __shared__ uint8_t valid_s[kBlockK];

  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int row0 = qi * kBlockQ + tr * 4;  // first q row (sequence index) owned

  const long q_row_stride = (long)Hq * kHeadDim;
  const long kv_row_stride = (long)Hkv * kHeadDim;
  const __nv_bfloat16* q_base = q + ((long)b * T + qi * kBlockQ) * q_row_stride + (long)h * kHeadDim;
  const __nv_bfloat16* k_base = k + (long)b * S * kv_row_stride + (long)hk * kHeadDim;
  const __nv_bfloat16* v_base = v + (long)b * S * kv_row_stride + (long)hk * kHeadDim;

  load_tile(q_s, q_base, q_row_stride);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  int n_k = S / kBlockK;
  if (causal) {
    // A tile runs only if (qi+1)*bq - 1 >= ki*bk (whole tiles above the
    // diagonal contribute nothing).
    const int last = ((qi + 1) * kBlockQ - 1) / kBlockK;
    n_k = min(n_k, last + 1);
  }

  for (int ki = 0; ki < n_k; ++ki) {
    __syncthreads();  // previous tile's P.V reads of kv_s and p_s are done
    load_tile(kv_s, k_base + (long)ki * kBlockK * kv_row_stride, kv_row_stride);
    if (tid < kBlockK) valid_s[tid] = kv_valid[(long)b * S + ki * kBlockK + tid];
    __syncthreads();

    // Scores: s[i][j] = q[row0+i] . k[ki*64 + tc + 16j].
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; d += 2) {
      float2 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q_s[tr * 4 + i][d]));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kv_s[tc + 16 * j][d]));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(qf[i].y, kf[j].y, fmaf(qf[i].x, kf[j].x, s[i][j]));
    }

    // Mask, then the online-softmax update per row.
    bool ok[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = ki * kBlockK + tc + 16 * j;
      const bool valid = valid_s[tc + 16 * j] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ok[i][j] = valid && (!causal || col <= row0 + i);
        s[i][j] = ok[i][j] ? s[i][j] * scale : kNegInf;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m_cur = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_next = fmaxf(m[i], m_cur);
      const float alpha = expf(m[i] - m_next);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[i][j] ? expf(s[i][j] - m_next) : 0.f;
        row_sum += p;
        p_s[tr * 4 + i][tc + 16 * j] = __float2bfloat16(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      m[i] = m_next;
      l[i] = alpha * l[i] + row_sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every warp is done reading K out of kv_s
    load_tile(kv_s, v_base + (long)ki * kBlockK * kv_row_stride, kv_row_stride);
    __syncthreads();

    // acc[i][2jj + e] += sum_c p[row0+i][c] * v[c][2tc + 32jj + e].
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pf[4];
      float2 vf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[i] = __bfloat162float(p_s[tr * 4 + i][c]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        vf[jj] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kv_s[c][2 * tc + 32 * jj]));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][2 * jj] = fmaf(pf[i], vf[jj].x, acc[i][2 * jj]);
          acc[i][2 * jj + 1] = fmaf(pf[i], vf[jj].y, acc[i][2 * jj + 1]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    __nv_bfloat16* o_row = out + ((long)b * T + row0 + i) * q_row_stride + (long)h * kHeadDim;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      *reinterpret_cast<__nv_bfloat162*>(o_row + 2 * tc + 32 * jj) =
          __floats2bfloat162_rn(acc[i][2 * jj] * l_inv, acc[i][2 * jj + 1] * l_inv);
    }
    if (tc == 0) {
      const long r = ((long)b * Hq + h) * T + row0 + i;
      m_out[r] = m[i];
      l_out[r] = l[i];
    }
  }
}

}  // namespace

extern "C" int vzt_flash_fwd(const void* q, const void* k, const void* v,
                             const void* kv_valid, void* out, void* m_out,
                             void* l_out, int B, int T, int S, int Hq, int Hkv,
                             int causal, float scale, void* stream) {
  const dim3 grid(T / kBlockQ, Hq, B);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), T, S, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vzt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
