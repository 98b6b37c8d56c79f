// K3 paged_attn_decode: attention of S query rows per slot over a KV cache
// kept as fixed-size pages in shared pools (bf16 or int8 with per-row scales,
// K and V in two pools or fused in one), with the current token folded in as
// a last online-softmax term.
//
// Replaces the TPU kernels `vis_zephyr_tpu/ops/paged_attention.py::_fa_mh_kernel`
// (:604) and `::_fa_gmh_kernel` (:911), one function, `paged_attention_fa`, under
// two TPU schedules; `::_fa_kernel` (:417), the same function on the TPU's
// (slot, kv head) grid (`fold_heads=False`); and `::_make_kernel` (:109), the
// single-row entry `paged_attention` over split pools with the self-term (the
// block-spec page walk). All four are this kernel with S = 1 or more rows: the
// TPU folded the kv heads into one grid cell to divide a fixed cost per cell
// (`paged_attention.py:1286-1305`), which a CUDA block does not pay in the same
// way, so this grid (kv head, slot, row tile) serves every schedule. Same
// arithmetic:
// - scores s = (q . kq) * scale * (k_scale / 127.5) with f32 accumulation (the
//   int8 -> float convert is exact); mask slot <= qpos, slot < length and
//   slot > qpos - window; a masked score is -0.7 * FLT_MAX; m starts at -inf
//   and l at 0;
// - l sums the f32 probabilities; the probabilities that enter P.V are first
//   multiplied by v_scale / 127.5 and rounded to bf16;
// - the self-term (k_new, v_new: the token being decoded, not yet in the
//   pool) is folded in last, in f32 and unquantized even over int8 pools;
// - a row with no key at all writes exact zeros.
// Rows of a page at or past `length` are never loaded, so whatever bytes a
// recycled page still holds cannot reach the output.
//
// Port layout: pools [N, Hkv, rows, D] with N = layers * pages, rows = ps
// (split pools) or 2 * ps (fused: K rows then V rows of the page); scales
// [N, Hkv, rows] f32. `page_offset` (layer * pages) is added to every table
// entry, so one table serves all layers without a copy per layer.
//
// What bounds it on the H100: bytes. A decode step reads every valid K and V
// row of every slot once per layer and does 4 * G multiply-adds per byte of
// int8 KV, far under the card's operations-per-byte line. This first version
// walks a slot's pages one after the other in one block per (slot, kv head,
// row tile), with plain loads and CUDA-core FMAs; it does not overlap a page's
// load with the previous page's arithmetic, so it sits well under the memory
// rate, and a tile of 32 rows (the verify step) does 8 times the decode
// step's arithmetic per byte on CUDA cores (PERF.md has the times).
// cp.async/TMA pipelines, mma for the multi-row tiles and a split of long
// sequences over several blocks are later work.
//
// What the design does about it:
// - grid (kv head, slot, row tile): 128 threads per block. A (slot, kv head)
//   has S * G query rows (G = Hq / Hkv); a block takes a tile of R of them,
//   R the least of 4, 8, 16 and 32 that holds them all, and rows beyond 32
//   go to further tiles, each its own block over the slot's pages (the
//   verify step's S = lookahead + 1 rows: 20 at lookahead 4 and G = 4).
//   Each tile skips the pages that lie wholly after its last query row. The loop over pages inside
//   the block takes the place of the TPU's sequential grid, so m, l (shared
//   memory, one value per query row) and the output accumulator (registers:
//   thread d owns head-dim column d of all R rows) never touch device memory.
// - R = S * G query rows share every K and V byte the block loads (GQA).
// - A page's valid K and V rows are staged in shared memory with 16-byte
//   loads, all issued before the first use, so the page's whole read is in
//   flight at once (reading V from device memory one row at a time inside the
//   P.V loop left one short load in flight per thread: 0.35 ms against
//   0.19 ms for 32 slots of 2048 tokens, int8 fused pools, on an H100 80GB
//   HBM3 at 700 W). K rows are read back one row per thread; rows are padded by 16
//   bytes so that the threads of a quarter-warp hit different banks. In the
//   P.V loop thread d reads column d, so a warp reads consecutive bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -0.7f * FLT_MAX;  // the TPU kernel's NEG_INF
constexpr float kInvQuantMax = 1.0f / 127.5f;

struct Params {
  const __nv_bfloat16* q;    // [B, S, Hq, D]
  __nv_bfloat16* out;        // [B, S, Hq, D]
  const void* k_pool;        // [N, Hkv, rows, D]
  const void* v_pool;        // the same pool when fused
  const float* k_scales;     // [N, Hkv, rows] or null (bf16 pools)
  const float* v_scales;
  const int32_t* page_table; // [B, pps]
  const int32_t* lengths;    // [B] tokens of the slot that are in the pool
  const int32_t* q_offs;     // [B] position of query row 0
  const __nv_bfloat16* k_new;  // [B, Hkv, D] or null
  const __nv_bfloat16* v_new;
  int S, Hq, Hkv, G;
  int ps, pps, rows, v_row0;  // v_row0: first V row of a page (ps when fused)
  int page_offset;
  int window;                 // 0: no sliding window
  float scale;
};

__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of a K row -> floats.
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[16 / sizeof(int8_t)], int8_t) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 16; ++j) f[j] = static_cast<float>(b[j]);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[16 / sizeof(__nv_bfloat16)],
                                       __nv_bfloat16) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(b[j]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename KV, int R>
__global__ void __launch_bounds__(kThreads) paged_attn_decode_kernel(const Params p) {
  constexpr int kElems = 16 / sizeof(KV);            // elements per 16-byte vector
  constexpr int kVecPerRow = kHeadDim / kElems;
  constexpr int kRowBytes = kHeadDim * sizeof(KV) + 16;  // padded shared K row

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * R;  // the tile's first query row of this (slot, kv head)
  const int n_rows = p.S * p.G;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ps = p.ps;
  const bool quant = p.k_scales != nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);                  // [R][D]
  float* s_s = q_s + R * kHeadDim;                              // [R][ps]
  float* m_s = s_s + R * ps;                                    // [R]
  float* l_s = m_s + R;
  float* alpha_s = l_s + R;
  // 3 * R floats of state, rounded up to a 16-byte boundary.
  unsigned char* k_s = reinterpret_cast<unsigned char*>(alpha_s + R + ((4 - (3 * R) % 4) % 4));
  unsigned char* v_s = k_s + ps * kRowBytes;                    // [ps][padded row]

  const int length = p.lengths[b];
  const int q_off = p.q_offs[b];

  for (int idx = tid; idx < R * kHeadDim; idx += kThreads) {
    const int r = row0 + idx / kHeadDim, d = idx % kHeadDim;
    float x = 0.0f;  // rows past n_rows: computed, never written
    if (r < n_rows) {
      const long row = ((long)b * p.S + r / p.G) * p.Hq + h * p.G + r % p.G;
      x = __bfloat162float(p.q[row * kHeadDim + d]);
    }
    q_s[idx] = x;
  }
  if (tid < R) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  __syncthreads();

  int n_pages = (length + ps - 1) / ps;
  if (n_pages > p.pps) n_pages = p.pps;
  // Pages wholly after the tile's last query row are masked for all its rows.
  const int last_pos = q_off + (min(n_rows, row0 + R) - 1) / p.G;
  n_pages = min(n_pages, last_pos < 0 ? 0 : last_pos / ps + 1);
  int first_page = 0;
  if (p.window > 0) {
    const int lo = q_off + row0 / p.G - (p.window - 1);
    first_page = lo > 0 ? lo / ps : 0;
  }

  for (int pi = first_page; pi < n_pages; ++pi) {
    const long page = (long)p.page_table[b * p.pps + pi] + p.page_offset;
    const long page_row0 = (page * p.Hkv + h) * p.rows;  // first row of this (page, head)
    const int slot0 = pi * ps;
    const int n_tok = min(ps, length - slot0);            // rows of the page below `length`

    // K and V rows [0, n_tok) -> shared memory.
    const uint4* k_src = reinterpret_cast<const uint4*>(
        static_cast<const KV*>(p.k_pool) + page_row0 * kHeadDim);
    const uint4* v_src = reinterpret_cast<const uint4*>(
        static_cast<const KV*>(p.v_pool) + (page_row0 + p.v_row0) * kHeadDim);
#pragma unroll 4
    for (int idx = tid; idx < n_tok * kVecPerRow; idx += kThreads) {
      const int t = idx / kVecPerRow, c = idx % kVecPerRow;
      const uint4 kx = k_src[idx];
      const uint4 vx = v_src[idx];
      *reinterpret_cast<uint4*>(k_s + t * kRowBytes + c * 16) = kx;
      *reinterpret_cast<uint4*>(v_s + t * kRowBytes + c * 16) = vx;
    }
    __syncthreads();

    // Scores: one token per thread, all R rows.
    for (int t = tid; t < ps; t += kThreads) {
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.0f;
      if (t < n_tok) {
        const unsigned char* row = k_s + t * kRowBytes;
#pragma unroll 2
        for (int c = 0; c < kVecPerRow; ++c) {
          float kf[kElems];
          unpack(*reinterpret_cast<const uint4*>(row + c * 16), kf, KV());
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float* qr = q_s + r * kHeadDim + c * kElems;
#pragma unroll
            for (int j = 0; j < kElems; ++j) dot[r] = fmaf(kf[j], qr[j], dot[r]);
          }
        }
      }
      const int slot = slot0 + t;
      float k_mul = 1.0f;
      if (quant && t < n_tok) k_mul = p.k_scales[page_row0 + t] * kInvQuantMax;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int qpos = q_off + (row0 + r) / p.G;
        bool ok = t < n_tok && slot <= qpos;
        if (p.window > 0) ok = ok && slot > qpos - p.window;
        float s = dot[r] * p.scale;
        if (quant) s *= k_mul;
        s_s[r * ps + t] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: one warp per query row.
    for (int r = warp; r < R; r += kWarps) {
      float m_curr = kNegInf;
      for (int t = lane; t < ps; t += 32) m_curr = fmaxf(m_curr, s_s[r * ps + t]);
      m_curr = warp_max(m_curr);
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, m_curr);
      const float alpha = expf(m_prev - m_next);
      float sum = 0.0f;
      for (int t = lane; t < ps; t += 32) {
        const float s = s_s[r * ps + t];
        float pexp = 0.0f;
        if (s != kNegInf) {
          pexp = expf(s - m_next);
          sum += pexp;
          if (quant) pexp *= p.v_scales[page_row0 + p.v_row0 + t] * kInvQuantMax;
          pexp = __bfloat162float(__float2bfloat16_rn(pexp));
        }
        s_s[r * ps + t] = pexp;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_next;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // P.V: thread d owns column d of every row.
    const KV* v_col = reinterpret_cast<const KV*>(v_s) + tid;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] *= alpha_s[r];
#pragma unroll 4
    for (int t = 0; t < n_tok; ++t) {
      const float vf = to_float(*reinterpret_cast<const KV*>(
          reinterpret_cast<const unsigned char*>(v_col) + t * kRowBytes));
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(s_s[r * ps + t], vf, acc[r]);
    }
    __syncthreads();
  }

  if (p.k_new != nullptr) {
    const __nv_bfloat16* kn = p.k_new + ((long)b * p.Hkv + h) * kHeadDim;
    for (int r = warp; r < R; r += kWarps) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kHeadDim / 32; ++j) {
        const int d = lane * (kHeadDim / 32) + j;
        dot = fmaf(q_s[r * kHeadDim + d], __bfloat162float(kn[d]), dot);
      }
      const float s_self = warp_sum(dot) * p.scale;
      if (lane == 0) {
        const float m_prev = m_s[r];
        const float m_next = fmaxf(m_prev, s_self);
        const float alpha = expf(m_prev - m_next);
        const float p_self = expf(s_self - m_next);
        l_s[r] = alpha * l_s[r] + p_self;
        m_s[r] = m_next;
        alpha_s[r] = alpha;
        s_s[r * ps] = p_self;
      }
    }
    __syncthreads();
    const float vn = __bfloat162float(p.v_new[((long)b * p.Hkv + h) * kHeadDim + tid]);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = acc[r] * alpha_s[r] + s_s[r * ps] * vn;
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gr = row0 + r;
    if (gr >= n_rows) break;
    const float l = l_s[r];
    const float l_inv = l == 0.0f ? 0.0f : 1.0f / l;
    const long row = ((long)b * p.S + gr / p.G) * p.Hq + h * p.G + gr % p.G;
    p.out[row * kHeadDim + tid] = __float2bfloat16_rn(acc[r] * l_inv);
  }
}

template <typename KV, int R>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t state = (size_t)(R * kHeadDim + R * p.ps + 3 * R + (4 - (3 * R) % 4) % 4) * 4;
  const size_t smem = state + 2 * (size_t)p.ps * (kHeadDim * sizeof(KV) + 16);  // K and V
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attn_decode_kernel<KV, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (p.S * p.G + R - 1) / R;
  paged_attn_decode_kernel<KV, R><<<dim3(p.Hkv, B, tiles), kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tile: the least of 4, 8, 16 and 32 rows that holds all S * G rows of a
// (slot, kv head), else tiles of 32 (decode with G = 4 is R = 4).
template <typename KV>
int dispatch_rows(const Params& p, int B, cudaStream_t stream) {
  const int rows = p.S * p.G;
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 4) return launch<KV, 4>(p, B, stream);
  if (rows <= 8) return launch<KV, 8>(p, B, stream);
  if (rows <= 16) return launch<KV, 16>(p, B, stream);
  return launch<KV, 32>(p, B, stream);
}

}  // namespace

// kv_int8: 1 for int8 pools (scales given), 0 for bf16 pools. v_pool/v_scales
// null: fused pools (V rows follow the K rows inside each page). Head dim 128
// (the wrapper checks it); any S >= 1.
extern "C" int vzt_paged_attn_decode(const void* q, void* out, const void* k_pool,
                                     const void* v_pool, const void* k_scales,
                                     const void* v_scales, const void* page_table,
                                     const void* lengths, const void* q_offs, const void* k_new,
                                     const void* v_new, int B, int S, int Hq, int Hkv, int ps,
                                     int pps, int page_offset, int window, int kv_int8,
                                     float scale, void* stream) {
  const bool fused = v_pool == nullptr;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.k_pool = k_pool;
  p.v_pool = fused ? k_pool : v_pool;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = fused ? p.k_scales : static_cast<const float*>(v_scales);
  p.page_table = static_cast<const int32_t*>(page_table);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.q_offs = static_cast<const int32_t*>(q_offs);
  p.k_new = static_cast<const __nv_bfloat16*>(k_new);
  p.v_new = static_cast<const __nv_bfloat16*>(v_new);
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.ps = ps;
  p.pps = pps;
  p.rows = fused ? 2 * ps : ps;
  p.v_row0 = fused ? ps : 0;
  p.page_offset = page_offset;
  p.window = window;
  p.scale = scale;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kv_int8 ? dispatch_rows<int8_t>(p, B, s) : dispatch_rows<__nv_bfloat16>(p, B, s);
}
