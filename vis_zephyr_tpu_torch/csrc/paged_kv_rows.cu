// K4 paged_kv_rows: write K/V rows into the page pools, in place, quantizing
// to int8 with a per-row absmax scale when the pools are int8. Two entries on
// one kernel:
// - `vzt_paged_kv_rows` replaces the TPU kernel
//   `vis_zephyr_tpu/ops/paged_attention.py::_kv_update_rows_kernel` (wrappers
//   `paged_kv_update_rows{,_q}`): one decode step's rows of every layer; slot
//   b's row of layer l lands at page `l * P + pages[b]` (within-layer ids
//   [B]);
// - `vzt_paged_kv_update` replaces `::_kv_update_kernel` and
//   `::_kv_update_quant_kernel` (wrappers `paged_kv_update{,_q}`): row (l, b)
//   lands at the ABSOLUTE page `page_ids[l, b]` ([L, B]). The speculative
//   verify step calls it with L = 1, once per candidate row and layer.
// Both: rows ks/vs [L, B, Hkv, D]; row `offsets[b]` (K) and, in a fused
// pool, row `ps + offsets[b]` (V) of the page. int8 pools: scale = max |x|
// of the row (f32), value = rint(x * (127.5 / max(scale, 1e-9))) clamped to
// [-128, 127] (the row's largest positive element rounds to 128 and
// saturates to 127), scale stored beside it.
//
// Port layout: pools [L * P, Hkv, rows, D], scales [L * P, Hkv, rows] f32
// (rows = ps, or 2 * ps when fused).
//
// What bounds it on the H100: launch latency. A step at B = 32 writes
// 2 * 32 * 32 * 8 rows of 128 int8 (2 MB) plus scales; a verify write at
// L = 1, B = 32 writes 512 rows (64 KB).
//
// What the design does about it: one block per (kv head, layer, slot) row
// pair, thread d owning element d of the K row and of the V row; the absmax
// is a warp shuffle plus one shared-memory exchange. A GPU writes single
// rows, so the TPU kernel's read-modify-write of an aligned 32-row tile and
// its slots-per-cell grouping have no counterpart, and rows that share a
// page need no ordering. The page of (l, b) is
// `l * layer_pages + pages[l * pid_layer_stride + b]`: (P, 0) for the
// within-layer form, (0, B) for the absolute one. Inactive slots all write
// the trash page 0 at once: a race among rows that no active slot reads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kQuantMax = 127.5f;

// max over the block of |x|; every thread returns it. `slot` is shared scratch
// of 32 floats.
__device__ __forceinline__ float block_absmax(float x, float* slot) {
  float m = fabsf(x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = (blockDim.x + 31) / 32;
  if (lane == 0) slot[warp] = m;
  __syncthreads();
  m = lane < n_warps ? slot[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __syncthreads();
  return m;
}

__device__ __forceinline__ int8_t quantize(float x, float absmax) {
  const int q = __float2int_rn(__fmul_rn(x, kQuantMax / fmaxf(absmax, 1e-9f)));
  return static_cast<int8_t>(max(-128, min(127, q)));
}

template <bool kQuant>
__global__ void paged_kv_rows_kernel(void* __restrict__ k_pool, void* __restrict__ v_pool,
                                     float* __restrict__ k_scales, float* __restrict__ v_scales,
                                     const __nv_bfloat16* __restrict__ ks,
                                     const __nv_bfloat16* __restrict__ vs,
                                     const int32_t* __restrict__ pages,
                                     const int32_t* __restrict__ offsets, int B, int Hkv, int D,
                                     int layer_pages, int pid_layer_stride, int rows,
                                     int v_row0) {
  __shared__ float scratch[32];
  const int h = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const bool live = d < D;
  const long src = (((long)l * B + b) * Hkv + h) * D + d;
  const float kx = live ? __bfloat162float(ks[src]) : 0.0f;
  const float vx = live ? __bfloat162float(vs[src]) : 0.0f;
  const long page = (long)l * layer_pages + pages[l * pid_layer_stride + b];
  const long k_row = (page * Hkv + h) * rows + offsets[b];
  const long v_row = k_row + v_row0;
  if (kQuant) {
    const float k_max = block_absmax(kx, scratch);
    const float v_max = block_absmax(vx, scratch);
    if (live) {
      static_cast<int8_t*>(k_pool)[k_row * D + d] = quantize(kx, k_max);
      static_cast<int8_t*>(v_pool)[v_row * D + d] = quantize(vx, v_max);
    }
    if (d == 0) {
      k_scales[k_row] = k_max;
      v_scales[v_row] = v_max;
    }
  } else if (live) {
    static_cast<__nv_bfloat16*>(k_pool)[k_row * D + d] = ks[src];
    static_cast<__nv_bfloat16*>(v_pool)[v_row * D + d] = vs[src];
  }
}

int launch_rows(void* k_pool, void* v_pool, void* k_scales, void* v_scales, const void* ks,
                const void* vs, const void* pages, const void* offsets, int L, int B, int Hkv,
                int D, int layer_pages, int pid_layer_stride, int ps, void* stream) {
  if (L == 0 || B == 0) return 0;
  const bool fused = v_pool == nullptr;
  const bool quant = k_scales != nullptr;
  const int rows = fused ? 2 * ps : ps;
  const int v_row0 = fused ? ps : 0;
  if (fused) {
    v_pool = k_pool;
    v_scales = k_scales;
  }
  const int threads = (D + 31) / 32 * 32;
  const dim3 grid(Hkv, L, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = quant ? paged_kv_rows_kernel<true> : paged_kv_rows_kernel<false>;
  kernel<<<grid, threads, 0, s>>>(k_pool, v_pool, static_cast<float*>(k_scales),
                                  static_cast<float*>(v_scales),
                                  static_cast<const __nv_bfloat16*>(ks),
                                  static_cast<const __nv_bfloat16*>(vs),
                                  static_cast<const int32_t*>(pages),
                                  static_cast<const int32_t*>(offsets), B, Hkv, D, layer_pages,
                                  pid_layer_stride, rows, v_row0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v_pool (and v_scales) null: fused pools. k_scales null: bf16 pools.
// pages [B] within-layer ids; P pages per layer.
extern "C" int vzt_paged_kv_rows(void* k_pool, void* v_pool, void* k_scales, void* v_scales,
                                 const void* ks, const void* vs, const void* pages,
                                 const void* offsets, int L, int B, int Hkv, int D, int P,
                                 int ps, void* stream) {
  return launch_rows(k_pool, v_pool, k_scales, v_scales, ks, vs, pages, offsets, L, B, Hkv, D,
                     P, 0, ps, stream);
}

// The same with page_ids [L, B] absolute pool pages.
extern "C" int vzt_paged_kv_update(void* k_pool, void* v_pool, void* k_scales, void* v_scales,
                                   const void* ks, const void* vs, const void* page_ids,
                                   const void* offsets, int L, int B, int Hkv, int D, int ps,
                                   void* stream) {
  return launch_rows(k_pool, v_pool, k_scales, v_scales, ks, vs, page_ids, offsets, L, B, Hkv,
                     D, 0, B, ps, stream);
}
