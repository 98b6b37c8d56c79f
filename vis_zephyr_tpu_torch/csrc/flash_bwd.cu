// K7 flash_bwd_dkv and K8 flash_bwd_dq: the flash attention backward pass
// (bf16 in and out, f32 arithmetic), recomputed from K1's softmax residuals.
//
// Replace the TPU kernels `vis_zephyr_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel` (K7) and `::_bwd_dq_kernel` (K8), whose grids
// `_flash_backward` builds. Same contract, on the port's public layout read
// in place through strides: q and dO [B,T,Hq,D], k and v [B,S,Hkv,D] bf16;
// kv_valid [B,S] bool; K1's per-row residuals m and l and di = rowsum(o.dO),
// f32 [B,Hq,T]. Causal masking on row indices (col <= row) with whole-tile
// skipping; GQA (q head h reads kv head h / (Hq/Hkv)). Probabilities are
// recomputed as p = mask ? exp(s*scale - m) * (l == 0 ? 0 : 1/l) : 0, so a
// row with no valid key (K1 leaves m = -0.7*FLT_MAX, l = 0 there) gives
// dQ = 0 and an invalid key dK = dV = 0. ds = p * (dp - di) * scale with
// dp = dO.v. p and ds stay f32 (the TPU kernels multiply f32 p; only K1's
// forward rounds P to bf16), every product accumulates in f32, and the
// outputs are rounded to bf16 once.
//
// What bounds them on the H100: arithmetic. Per (64-row, 64-column) tile K7
// does 4 products of 64*64*128 multiply-adds (s, dp, dV, dK) and K8 3 (s, dp,
// dQ); with T=2048 the tiles reuse every byte they load hundreds of times.
// This first version runs the products on the CUDA cores in f32 FMAs, as K1
// does, far below the bf16 tensor-core peak; mma.sync / wgmma, TMA and a
// pipelined K/V ring are later work.
//
// What the design does about it:
// - K7: one block per (64-key tile, kv head, batch row). It loads its K and V
//   tiles once and loops over the Hq/Hkv q heads of the GQA group and, for
//   each, over the q tiles at or below the diagonal, so dK and dV of the
//   whole group sum in f32 registers and are written once, [B,S,Hkv,D]: no
//   per-q-head buffers and no separate group sum, which the TPU kernel
//   needs because its grid cells cannot share an accumulator.
// - K8: one block per (64-row q tile, q head, batch row), like K1: Q, dO and
//   the row residuals stay put and the loop over K/V tiles up to the diagonal
//   takes the place of the TPU's sequential grid axis; dQ lives in registers.
// - 256 threads; thread (tr, tc) = (tid / 16, tid % 16) owns four "own" rows
//   4*tr .. 4*tr+3 (keys in K7, queries in K8) and, in the score tile,
//   columns tc + 16*j; in the accumulators it owns head-dim pairs
//   2*tc + 32*j. Bf16 rows are padded to 132 elements (66 words), so the 16
//   lanes that read 16 different rows hit 16 different banks; the f32 tiles
//   of p and ds are padded to 68 words, so a warp's two half-warps write
//   disjoint banks.
// - Four 64x128 bf16 tiles (q, dO, k, v) take 66 KB, over the 48 KB static
//   limit: shared memory is dynamic (101 KB for K7, 83 KB for K8), granted
//   by cudaFuncSetAttribute before each launch, whose code is returned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;                 // q-tile rows and kv-tile rows
constexpr int kHeadDim = 128;
constexpr int kRowStride = kHeadDim + 4;   // bf16 elements per shared row
constexpr int kPStride = kBlock + 4;       // f32 words per shared p/ds row
constexpr int kThreads = 256;

typedef __nv_bfloat16 BfRow[kRowStride];
typedef float FRow[kPStride];

struct DkvSmem {
  BfRow k[kBlock];
  BfRow v[kBlock];
  BfRow q[kBlock];
  BfRow dout[kBlock];
  FRow p[kBlock];
  FRow ds[kBlock];
  float m[kBlock];
  float linv[kBlock];
  float di[kBlock];
  uint8_t valid[kBlock];
};

struct DqSmem {
  BfRow q[kBlock];
  BfRow dout[kBlock];
  BfRow k[kBlock];
  BfRow v[kBlock];
  FRow ds[kBlock];
  uint8_t valid[kBlock];
};

// Copies a [64, 128] bf16 tile whose rows are `row_stride` elements apart in
// global memory into a padded shared tile: 16-byte loads, two 8-byte stores.
__device__ __forceinline__ void load_tile(BfRow* dst, const __nv_bfloat16* src,
                                          long row_stride) {
  constexpr int kVecPerRow = kHeadDim / 8;  // uint4 per row
  for (int idx = threadIdx.x; idx < kBlock * kVecPerRow; idx += kThreads) {
    const int row = idx / kVecPerRow;
    const int col = (idx % kVecPerRow) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(src + row * row_stride + col);
    uint2* out = reinterpret_cast<uint2*>(&dst[row][col]);
    out[0] = make_uint2(val.x, val.y);
    out[1] = make_uint2(val.z, val.w);
  }
}

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// a[i][j] = A[own 4*tr+i] . B[tc+16j] and c[i][j] = C[own] . E[tc+16j] over
// the head dimension: the two score-shaped products each kernel needs
// (s = q.k and dp = dO.v, with the roles of rows and columns per kernel).
__device__ __forceinline__ void two_score_tiles(const BfRow* A, const BfRow* Bm,
                                                const BfRow* C, const BfRow* E,
                                                int tr, int tc, float (&a)[4][4],
                                                float (&c)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = c[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < kHeadDim; d += 2) {
    float2 af[4], bf[4], cf[4], ef[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      af[i] = bf2(&A[tr * 4 + i][d]);
      cf[i] = bf2(&C[tr * 4 + i][d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf[j] = bf2(&Bm[tc + 16 * j][d]);
      ef[j] = bf2(&E[tc + 16 * j][d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = fmaf(af[i].y, bf[j].y, fmaf(af[i].x, bf[j].x, a[i][j]));
        c[i][j] = fmaf(cf[i].y, ef[j].y, fmaf(cf[i].x, ef[j].x, c[i][j]));
      }
  }
}

// acc[i][2jj + e] += sum_c W[own 4*tr+i][c] * X[c][2tc + 32jj + e].
__device__ __forceinline__ void accumulate(float (&acc)[4][8], const FRow* W,
                                           const BfRow* X, int tr, int tc) {
#pragma unroll 4
  for (int c = 0; c < kBlock; ++c) {
    float w[4];
    float2 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[tr * 4 + i][c];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) x[jj] = bf2(&X[c][2 * tc + 32 * jj]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        acc[i][2 * jj] = fmaf(w[i], x[jj].x, acc[i][2 * jj]);
        acc[i][2 * jj + 1] = fmaf(w[i], x[jj].y, acc[i][2 * jj + 1]);
      }
  }
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long row_stride,
                                           const float (&acc)[4][8], int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(base + i * row_stride + 2 * tc + 32 * jj) =
          __floats2bfloat162_rn(acc[i][2 * jj], acc[i][2 * jj + 1]);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ kv_valid,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ di_in,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     int T, int S, int Hq, int Hkv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);

  const int ki = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int key0 = ki * kBlock + tr * 4;  // first key (sequence index) owned

  const long q_row_stride = (long)Hq * kHeadDim;
  const long kv_row_stride = (long)Hkv * kHeadDim;
  const long kv_off = ((long)b * S + ki * kBlock) * kv_row_stride + (long)hk * kHeadDim;

  load_tile(sm.k, k + kv_off, kv_row_stride);
  load_tile(sm.v, v + kv_off, kv_row_stride);
  if (tid < kBlock) sm.valid[tid] = kv_valid[(long)b * S + ki * kBlock + tid];
  __syncthreads();
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = sm.valid[tr * 4 + i] != 0;

  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // A q tile runs only if (qi+1)*bq - 1 >= ki*bk: with bq = bk, qi >= ki.
  const int n_q = T / kBlock;
  const int q_first = causal ? ki : 0;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int qi = q_first; qi < n_q; ++qi) {
      __syncthreads();  // the previous tile's readers of q, dout, p, ds, m are done
      const long q_off = ((long)b * T + qi * kBlock) * q_row_stride + (long)h * kHeadDim;
      load_tile(sm.q, q + q_off, q_row_stride);
      load_tile(sm.dout, dout + q_off, q_row_stride);
      if (tid < kBlock) {
        const long r = ((long)b * Hq + h) * T + qi * kBlock + tid;
        const float lv = l_in[r];
        sm.m[tid] = m_in[r];
        sm.linv[tid] = lv == 0.f ? 0.f : 1.f / lv;
        sm.di[tid] = di_in[r];
      }
      __syncthreads();

      // Transposed scores: s[i][j] = k[key0+i] . q[qi*64 + tc + 16j], and
      // dp[i][j] = v[key0+i] . dO[qi*64 + tc + 16j].
      float s[4][4], dp[4][4];
      two_score_tiles(sm.k, sm.q, sm.v, sm.dout, tr, tc, s, dp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tc + 16 * j;
        const int row = qi * kBlock + col;
        const float mj = sm.m[col], linvj = sm.linv[col], dij = sm.di[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool ok = key_ok[i] && (!causal || key0 + i <= row);
          const float p = ok ? expf(s[i][j] * scale - mj) * linvj : 0.f;
          sm.p[tr * 4 + i][col] = p;
          sm.ds[tr * 4 + i][col] = p * (dp[i][j] - dij) * scale;
        }
      }
      __syncthreads();
      accumulate(dv_acc, sm.p, sm.dout, tr, tc);   // dV += p^T dO
      accumulate(dk_acc, sm.ds, sm.q, tr, tc);     // dK += ds^T q
    }
  }

  store_rows(dk + kv_off + (long)tr * 4 * kv_row_stride, kv_row_stride, dk_acc, tc);
  store_rows(dv + kv_off + (long)tr * 4 * kv_row_stride, kv_row_stride, dv_acc, tc);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const uint8_t* __restrict__ kv_valid,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ di_in,
                    __nv_bfloat16* __restrict__ dq,
                    int T, int S, int Hq, int Hkv, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);

  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const int row0 = qi * kBlock + tr * 4;  // first q row (sequence index) owned

  const long q_row_stride = (long)Hq * kHeadDim;
  const long kv_row_stride = (long)Hkv * kHeadDim;
  const long q_off = ((long)b * T + qi * kBlock) * q_row_stride + (long)h * kHeadDim;
  const __nv_bfloat16* k_base = k + (long)b * S * kv_row_stride + (long)hk * kHeadDim;
  const __nv_bfloat16* v_base = v + (long)b * S * kv_row_stride + (long)hk * kHeadDim;

  load_tile(sm.q, q + q_off, q_row_stride);
  load_tile(sm.dout, dout + q_off, q_row_stride);

  float m[4], linv[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long r = ((long)b * Hq + h) * T + row0 + i;
    const float lv = l_in[r];
    m[i] = m_in[r];
    linv[i] = lv == 0.f ? 0.f : 1.f / lv;
    di[i] = di_in[r];
  }

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int n_k = S / kBlock;
  if (causal) n_k = min(n_k, ((qi + 1) * kBlock - 1) / kBlock + 1);

  for (int ki = 0; ki < n_k; ++ki) {
    __syncthreads();  // the previous tile's dQ reads of k and ds are done
    const long kv_off = (long)ki * kBlock * kv_row_stride;
    load_tile(sm.k, k_base + kv_off, kv_row_stride);
    load_tile(sm.v, v_base + kv_off, kv_row_stride);
    if (tid < kBlock) sm.valid[tid] = kv_valid[(long)b * S + ki * kBlock + tid];
    __syncthreads();

    // s[i][j] = q[row0+i] . k[ki*64 + tc + 16j]; dp[i][j] = dO[row0+i] . v[...].
    float s[4][4], dp[4][4];
    two_score_tiles(sm.q, sm.k, sm.dout, sm.v, tr, tc, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      const int col = ki * kBlock + c;
      const bool valid = sm.valid[c] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = valid && (!causal || col <= row0 + i);
        const float p = ok ? expf(s[i][j] * scale - m[i]) * linv[i] : 0.f;
        sm.ds[tr * 4 + i][c] = p * (dp[i][j] - di[i]) * scale;
      }
    }
    __syncthreads();
    accumulate(acc, sm.ds, sm.k, tr, tc);  // dQ += ds k
  }

  store_rows(dq + q_off + (long)tr * 4 * q_row_stride, q_row_stride, acc, tc);
}

}  // namespace

extern "C" int vzt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* kv_valid, const void* dout,
                                 const void* m, const void* l, const void* di,
                                 void* dk, void* dv, int B, int T, int S, int Hq,
                                 int Hkv, int causal, float scale, void* stream) {
  const int smem = static_cast<int>(sizeof(DkvSmem));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kBlock, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      T, S, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vzt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* kv_valid, const void* dout,
                                const void* m, const void* l, const void* di,
                                void* dq, int B, int T, int S, int Hq, int Hkv,
                                int causal, float scale, void* stream) {
  const int smem = static_cast<int>(sizeof(DqSmem));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(T / kBlock, Hq, B);
  flash_bwd_dq_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const float*>(di),
      static_cast<__nv_bfloat16*>(dq), T, S, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
