// K4 paged_kv_rows: write K/V rows into the page pools, in place, quantizing
// to int8 with a per-row absmax scale when the pools are int8. Two entries on
// one kernel:
// - `vzt_paged_kv_rows` replaces the TPU kernel
//   `vis_zephyr_tpu/ops/paged_attention.py::_kv_update_rows_kernel` (wrappers
//   `paged_kv_update_rows{,_q}`): one decode step's rows of every layer, ks
//   [L, B, Hkv, D]; slot b's row of layer l lands at page `l * P + pages[b]`
//   (within-layer ids [B]), row `offsets[b]`;
// - `vzt_paged_kv_update` replaces `::_kv_update_kernel` and
//   `::_kv_update_quant_kernel`: S rows a slot in one launch. Row (s, b) is
//   read at `ks + s * row_s + b * row_b`, lands at page `page_base +
//   page_ids[s, b]`, row `offsets[s * off_s + b]`. The wrappers
//   `paged_kv_update_layer{,_q}` pass a layer's verify rows as
//   `_project_qkv` returns them (ks [B, S, Hkv, D], within-layer ids and
//   offsets [S, B], page_base = layer * P); the JAX contract
//   `paged_kv_update{,_q}` passes ks [L, B, Hkv, D], absolute ids [L, B],
//   offsets [B] (off_s = 0) and page_base 0.
// In a fused pool the V row sits at `ps + offset` of the page. int8 pools:
// scale = max |x| of the row (f32), value = rint(x * (127.5 / max(scale,
// 1e-9))) clamped to [-128, 127] (the row's largest positive element rounds
// to 128 and saturates to 127), scale stored beside it.
//
// Port layout: pools [L * P, Hkv, rows, D], scales [L * P, Hkv, rows] f32
// (rows = ps, or 2 * ps when fused); rows bf16, D = 128.
//
// What bounds it on the H100: launches. A decode step at B = 32 writes
// 2 * 32 * 32 * 8 rows of 128 int8 (2 MB) plus scales from 4 MB of bf16
// rows (1.9 us at 3.35 TB/s); a verify step's layer at S = 5 writes 2560
// rows (0.3 MB). Each launch costs about 2 us of the device and 20-30 us
// of the host, so the design carries a layer's S rows in one launch (the TPU
// kernel and the JAX verify step write one row a call: consecutive rows of a
// slot can share an aligned tile, which the TPU rewrites whole; a GPU
// stores single rows, so rows of one slot need no order).
//
// What the design does about it: a block per row (s, b), a warp per kv head
// owning its K and V row; a lane holds 4 elements from one 8-byte load of
// each; the absmax is a shuffle butterfly (no shared memory); a lane stores
// its 4 int8 values as one 32-bit word, lane 0 the scale.
//
// Rows that land on one pool row in one launch (the trash page 0: inactive
// slots write their pad rows there, and the verify step forces a slot's rows
// past its span there) are written by the LAST of them in (s, b) order, as
// row-by-row writes in that order leave them: the block first asks whether
// a later row of the launch has its (page, row), its threads one later row
// each, and writes nothing if one has. Every launch's result is therefore
// defined, the plain version's is the
// same, and the smoke check compares whole pools, page 0 included. (The TPU
// kernel rewrites a whole page a grid cell, so where two cells of one call
// write different rows of the trash page it may keep a stale one; nothing
// reads that page.) The decode entry asks only among the rows of its own
// layer (the layers' pages are disjoint); the other among all of the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kQuantMax = 127.5f;
constexpr int kHeadDim = 128;  // 32 lanes x 4 elements
constexpr int kMaxHeads = 32;  // a block is a row's kv heads, a warp each

struct Rows {
  void* k_pool;
  void* v_pool;
  float* k_scales;
  float* v_scales;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int32_t* pages;
  const int32_t* offsets;
  int S, B, Hkv;
  long long row_s, row_b;        // elements between rows (s, b) and (s + 1, b) / (s, b + 1)
  int page_s;                    // ids between (s, b) and (s + 1, b): 0 = one id a slot
  int off_s;                     // offsets likewise
  long long page_base, page_step;  // page = page_base + s * page_step + pages[s * page_s + b]
  int rows, v_row0;              // rows of a (page, head); the V row's distance from the K row
  int scan_all;                  // 0: rows of different s never meet (the layers of a step)
};

__device__ __forceinline__ void target(const Rows& a, int s, int b, long long& page, int& off) {
  page = a.page_base + s * a.page_step + a.pages[s * a.page_s + b];
  off = a.offsets[s * a.off_s + b];
}

__device__ __forceinline__ void unpack(uint2 w, float (&x)[4]) {
  x[0] = __uint_as_float(w.x << 16);
  x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16);
  x[3] = __uint_as_float(w.y & 0xffff0000u);
}

__device__ __forceinline__ float warp_absmax(const float (&x)[4]) {
  float m = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// The 4 values' int8 codes, element 0 in the lowest byte.
__device__ __forceinline__ uint32_t quantize4(const float (&x)[4], float absmax) {
  const float inv = kQuantMax / fmaxf(absmax, 1e-9f);
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = max(-128, min(127, __float2int_rn(__fmul_rn(x[i], inv))));
    word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * i);
  }
  return word;
}

template <bool kQuant>
__global__ void __launch_bounds__(kMaxHeads * 32) paged_kv_rows_kernel(const Rows a) {
  const int lane = threadIdx.x & 31, h = threadIdx.x >> 5;
  const int item = blockIdx.x;
  const int s = item / a.B, b = item % a.B;
  // The rows first: their loads do not wait on the page lookup below.
  const long long src =
      s * a.row_s + b * a.row_b + static_cast<long long>(h) * kHeadDim + lane * 4;
  const uint2 kw = *reinterpret_cast<const uint2*>(a.ks + src);
  const uint2 vw = *reinterpret_cast<const uint2*>(a.vs + src);
  long long page;
  int off;
  target(a, s, b, page, off);
  // The last row in (s, b) order that lands here writes it: the block's
  // threads look at the later rows of the launch together, one each.
  const int end = a.scan_all ? a.S * a.B : (s + 1) * a.B;
  bool later = false;
  for (int j = item + 1 + threadIdx.x; j < end; j += blockDim.x) {
    long long pj;
    int oj;
    target(a, j / a.B, j % a.B, pj, oj);
    later |= pj == page && oj == off;
  }
  if (__syncthreads_or(later)) return;

  const long long k_row = (page * a.Hkv + h) * a.rows + off;
  const long long v_row = k_row + a.v_row0;
  if (kQuant) {
    float kx[4], vx[4];
    unpack(kw, kx);
    unpack(vw, vx);
    const float k_max = warp_absmax(kx);
    const float v_max = warp_absmax(vx);
    *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.k_pool) + k_row * kHeadDim + lane * 4) =
        quantize4(kx, k_max);
    *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.v_pool) + v_row * kHeadDim + lane * 4) =
        quantize4(vx, v_max);
    if (lane == 0) {
      a.k_scales[k_row] = k_max;
      a.v_scales[v_row] = v_max;
    }
  } else {
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.k_pool) + k_row * kHeadDim +
                              lane * 4) = kw;
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.v_pool) + v_row * kHeadDim +
                              lane * 4) = vw;
  }
}

int launch(Rows a, int D, int ps, void* stream) {
  if (D != kHeadDim || a.Hkv > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  if (a.S == 0 || a.B == 0) return 0;
  const bool fused = a.v_pool == nullptr;
  const bool quant = a.k_scales != nullptr;
  a.rows = fused ? 2 * ps : ps;
  a.v_row0 = fused ? ps : 0;
  if (fused) {
    a.v_pool = a.k_pool;
    a.v_scales = a.k_scales;
  }
  const unsigned blocks = static_cast<unsigned>(a.S) * a.B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quant) {
    paged_kv_rows_kernel<true><<<blocks, a.Hkv * 32, 0, s>>>(a);
  } else {
    paged_kv_rows_kernel<false><<<blocks, a.Hkv * 32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

Rows make_rows(void* k_pool, void* v_pool, void* k_scales, void* v_scales, const void* ks,
               const void* vs, const void* pages, const void* offsets, int S, int B, int Hkv) {
  Rows a{};
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = static_cast<float*>(k_scales);
  a.v_scales = static_cast<float*>(v_scales);
  a.ks = static_cast<const __nv_bfloat16*>(ks);
  a.vs = static_cast<const __nv_bfloat16*>(vs);
  a.pages = static_cast<const int32_t*>(pages);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.S = S;
  a.B = B;
  a.Hkv = Hkv;
  return a;
}

}  // namespace

// v_pool (and v_scales) null: fused pools. k_scales null: bf16 pools.
// ks [L, B, Hkv, D]; pages [B] within-layer ids, offsets [B]; P pages a layer.
extern "C" int vzt_paged_kv_rows(void* k_pool, void* v_pool, void* k_scales, void* v_scales,
                                 const void* ks, const void* vs, const void* pages,
                                 const void* offsets, int L, int B, int Hkv, int D, int P,
                                 int ps, void* stream) {
  Rows a = make_rows(k_pool, v_pool, k_scales, v_scales, ks, vs, pages, offsets, L, B, Hkv);
  a.row_s = static_cast<long long>(B) * Hkv * D;
  a.row_b = static_cast<long long>(Hkv) * D;
  a.page_s = 0;
  a.off_s = 0;
  a.page_base = 0;
  a.page_step = P;
  a.scan_all = 0;
  return launch(a, D, ps, stream);
}

// S rows a slot: row (s, b) at ks + s * row_s + b * row_b (elements), page
// page_base + page_ids[s * B + b], row offsets[s * off_s + b].
extern "C" int vzt_paged_kv_update(void* k_pool, void* v_pool, void* k_scales, void* v_scales,
                                   const void* ks, const void* vs, const void* page_ids,
                                   const void* offsets, int S, int B, int Hkv, int D, int ps,
                                   long long page_base, long long row_s, long long row_b,
                                   int off_s, void* stream) {
  Rows a = make_rows(k_pool, v_pool, k_scales, v_scales, ks, vs, page_ids, offsets, S, B, Hkv);
  a.row_s = row_s;
  a.row_b = row_b;
  a.page_s = B;
  a.off_s = off_s;
  a.page_base = page_base;
  a.page_step = 0;
  a.scan_all = 1;
  return launch(a, D, ps, stream);
}
