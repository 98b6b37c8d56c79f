// K10 paged_attn_batched and K11 paged_attn_paired: decode attention (one
// query row a slot, S = 1) over KV-fused int8 page pools with the current
// token folded in last, one block per slot (K10) or per group of P slots
// (K11), each block over every kv head of its slots.
//
// Replaces the TPU kernels `experiments/batched_paged_attention_probe.py::
// _batched_kernel` (:19, wrapper `fa_batched`: one grid cell per slot, all kv
// heads in one batched dot pair per block of tokens) and
// `experiments/paired_slot_attention_probe.py::_paired_kernel` (:28, wrapper
// `fa_paired`: one grid cell per P slots). They compute the function of K3
// (`paged_attn_decode.cu`) in its served configuration, with K3's arithmetic:
// - scores s = (q . kq) * scale * (k_scale / 127.5), f32 sums (int8 -> float
//   is exact); a slot's keys are the interval [max(0, qpos - window + 1),
//   min(length, qpos + 1)) with qpos = q_offs[b];
// - the online softmax steps over blocks of bk = pages_per_block * ps tokens,
//   numbered from token 0, as the TPU kernels' grid steps: m and the sum l
//   are updated once a block, and the probabilities that enter P.V are
//   exp(s - m) of the block's running maximum, times v_scale / 127.5,
//   rounded to bf16. So bk decides where the bf16 rounding happens, and
//   `paged_attention_grouped_plain` walks the same blocks;
// - the self-term (k_new, v_new: the token being decoded) is folded in last,
//   in f32 and unquantized; then acc / l, rounded to bf16.
// Rows at or past `length` are never loaded, so whatever a recycled page
// holds there (NaN scales included) cannot reach the output, and a slot of
// length 0 writes its self-term's v_new.
//
// Port layout: pool [N, Hkv, 2 * ps, D] int8 (a page's K rows, then its V
// rows, all heads of a page one contiguous piece), scales [N, Hkv, 2 * ps]
// f32, page table [B, pps] of within-layer ids plus `page_offset` (the
// probes' `table + i * P` per layer).
//
// What bounds it on the H100: bytes. At the probes' bench shape (B = 128
// slots of 640 tokens, Hkv = 8, D = 128) a layer reads 81920 tokens * 8
// heads * 2 * (128 + 4) bytes = 173.0 MB of KV and scales, 0.0516 ms at
// 3.35 TB/s (1.65 ms for a 32-layer step), for 1.34 GFLOP.
//
// What the design does about it (a first version that is right; PERF.md has
// its times):
// - a warp owns one (slot, kv head): the G <= 4 query rows of the head and
//   the slot's whole walk, so m, l and the output accumulator stay in
//   registers from the first block to the output. 8 lanes share a K or V row,
//   16 bytes each, so a warp step covers 4 tokens with 512 contiguous bytes,
//   and 8 steps (4 KB a warp) are loaded before any is used. A block runs at
//   most 8 warps (249 registers a thread, no spills), looping over its units
//   (slot, kv head) when P * Hkv is larger: K10 is 8 warps a slot at
//   Hkv = 8, K11 the same 8 warps walking P slots one after the other, so
//   B / P blocks share the card's 132 SMs.
// - scores of a block go to the warp's shared memory ([4 rows + the V
//   scales] x bk floats), then one pass takes the block's maximum, the
//   probabilities and their sum, and a second walk of the block's V rows
//   does P.V. int8 -> float is a byte permute into the mantissa of 2^23 and
//   one subtraction (no I2F, which an SM issues at a fraction of its FMA
//   rate).
// - the TPU kernels' machinery is not carried over: no DMA-descriptor run
//   detection, no semaphores, no prefetch across grid steps. A TPU grid cell
//   of P slots walked the group's widest block range in step, a member
//   outside its own range masked (alpha = 1, p = 0: its state does not
//   change); here each warp walks its own slot's blocks only, which gives
//   the same result, and blocks run at once.
// Left for later: loads of the next chunk issued before the current one is
// used (cp.async or TMA into a ring), mma for Q.K and P.V, and more blocks
// than slots at small B (a split of long sequences).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kRows = 4;                        // query rows a warp holds: G <= 4
constexpr int kLanesPerRow = 8;                 // lanes sharing one K or V row, 16 bytes each
constexpr int kTokensPerStep = 32 / kLanesPerRow;
constexpr int kUnroll = 8;                      // warp steps loaded before use
constexpr int kChunk = kTokensPerStep * kUnroll;
constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 232448;             // 227 KB a block
constexpr float kNegInf = -0.7f * FLT_MAX;      // the TPU kernels' NEG_INF
constexpr float kInvQuantMax = 1.0f / 127.5f;
constexpr float kMagic = 8388736.0f;            // 2^23 + 128

struct Params {
  const __nv_bfloat16* q;      // [B, Hq, D]
  __nv_bfloat16* out;          // [B, Hq, D]
  const int8_t* pool;          // [N, Hkv, 2 * ps, D]
  const float* scales;         // [N, Hkv, 2 * ps]
  const int32_t* page_table;   // [B, pps]
  const int32_t* lengths;      // [B] tokens of the slot in the pool
  const int32_t* q_offs;       // [B] the query's position
  const __nv_bfloat16* k_new;  // [B, Hkv, D]
  const __nv_bfloat16* v_new;
  int B, Hq, Hkv, G, ps, pps, bk, stride, page_offset, window, P;
  float scale;
};

// 16 int8 -> 16 floats: each byte, offset by 128, becomes the low mantissa
// byte of 2^23; subtracting 2^23 + 128 gives the value exactly.
__device__ __forceinline__ void int8x16_to_float(const uint4& raw, float (&f)[16]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j)) - kMagic;
  }
}

__device__ __forceinline__ void bf16x16_to_float(const __nv_bfloat16* src, float (&f)[16]) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint4 b = *reinterpret_cast<const uint4*>(src + 8);
  const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&a);
  const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j] = __bfloat162float(x[j]);
    f[8 + j] = __bfloat162float(y[j]);
  }
}

// Sum over the 8 lanes that share a row.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanesPerRow; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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

// One (slot b, kv head h) by one warp: the slot's blocks, then the self-term.
// s_w: the warp's shared memory, rows 0..3 the block's scores (then its
// probabilities), row 4 its V scales; `stride` floats a row.
__device__ void attend_unit(const Params& p, int b, int h, float* s_w) {
  const int lane = threadIdx.x % 32;
  const int grp = lane / kLanesPerRow;  // which token of a warp step
  const int sub = lane % kLanesPerRow;  // which 16 columns
  const int c0 = sub * 16;
  const int ps = p.ps;
  const int length = p.lengths[b];
  const int q_off = p.q_offs[b];
  const int hi = min(min(length, q_off + 1), p.pps * ps);
  const int lo = p.window > 0 ? max(q_off - p.window + 1, 0) : 0;
  const int32_t* table = p.page_table + (long)b * p.pps;

  float qf[kRows][16];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < p.G) {
      bf16x16_to_float(p.q + ((long)b * p.Hq + h * p.G + r) * kHeadDim + c0, qf[r]);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) qf[r][j] = 0.0f;
    }
  }
  float acc[kRows][16];
  float m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[r][j] = 0.0f;
  }

  for (int blk = lo / p.bk; blk * p.bk < hi; ++blk) {
    const int a = max(blk * p.bk, lo);
    const int e = min((blk + 1) * p.bk, hi);
    if (a >= e) continue;
    const int n = e - a;

    // Scores of the block's tokens [a, e), page by page, and their V scales.
    for (int pg = a / ps; pg * ps < e; ++pg) {
      const int ta = max(pg * ps, a), te = min((pg + 1) * ps, e);
      const long row0 = ((long)(table[pg] + p.page_offset) * p.Hkv + h) * (2 * ps);
      const int8_t* k_rows = p.pool + row0 * kHeadDim + c0;
      const float* sc = p.scales + row0;
      for (int t0 = ta; t0 < te; t0 += kChunk) {
        uint4 raw[kUnroll];
        float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int t = t0 + k * kTokensPerStep + grp;
          raw[k] = make_uint4(0u, 0u, 0u, 0u);
          ksc[k] = vsc[k] = 0.0f;
          if (t < te) {
            const int row = t - pg * ps;
            raw[k] = *reinterpret_cast<const uint4*>(k_rows + (long)row * kHeadDim);
            ksc[k] = sc[row];
            vsc[k] = sc[ps + row];
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int t = t0 + k * kTokensPerStep + grp;
          float kf[16];
          int8x16_to_float(raw[k], kf);
          float mine = 0.0f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float dot = 0.0f;
#pragma unroll
            for (int j = 0; j < 16; ++j) dot = fmaf(qf[r][j], kf[j], dot);
            dot = row_sum(dot);
            if (sub == r) mine = dot;
          }
          if (t < te) {
            if (sub < p.G) s_w[sub * p.stride + (t - a)] = mine * p.scale * (ksc[k] * kInvQuantMax);
            if (sub == kRows) s_w[kRows * p.stride + (t - a)] = vsc[k];
          }
        }
      }
    }
    __syncwarp();

    // The block's maximum, the online-softmax step, and the probabilities
    // times the V scales, rounded to bf16 in place.
    float alpha[kRows], sum[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      alpha[r] = 1.0f;
      sum[r] = 0.0f;
      if (r < p.G) {
        float mx = kNegInf;
        for (int i = lane; i < n; i += 32) mx = fmaxf(mx, s_w[r * p.stride + i]);
        const float m_next = fmaxf(m[r], warp_max(mx));
        alpha[r] = expf(m[r] - m_next);
        m[r] = m_next;
      }
    }
    for (int i = lane; i < n; i += 32) {
      const float v_mul = s_w[kRows * p.stride + i] * kInvQuantMax;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < p.G) {
          const float e_x = expf(s_w[r * p.stride + i] - m[r]);
          sum[r] += e_x;
          s_w[r * p.stride + i] = __bfloat162float(__float2bfloat16_rn(e_x * v_mul));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < p.G) l[r] = alpha[r] * l[r] + warp_sum(sum[r]);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] *= alpha[r];
    }
    __syncwarp();

    // P.V over the block's V rows; each lane sums its token phase (grp) and
    // its 16 columns.
    for (int pg = a / ps; pg * ps < e; ++pg) {
      const int ta = max(pg * ps, a), te = min((pg + 1) * ps, e);
      const long row0 = ((long)(table[pg] + p.page_offset) * p.Hkv + h) * (2 * ps) + ps;
      const int8_t* v_rows = p.pool + row0 * kHeadDim + c0;
      for (int t0 = ta; t0 < te; t0 += kChunk) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int t = t0 + k * kTokensPerStep + grp;
          raw[k] = make_uint4(0u, 0u, 0u, 0u);
          if (t < te)
            raw[k] = *reinterpret_cast<const uint4*>(v_rows + (long)(t - pg * ps) * kHeadDim);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int t = t0 + k * kTokensPerStep + grp;
          if (t < te) {
            float vf[16];
            int8x16_to_float(raw[k], vf);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float pr = r < p.G ? s_w[r * p.stride + (t - a)] : 0.0f;
#pragma unroll
              for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(pr, vf[j], acc[r][j]);
            }
          }
        }
      }
    }
    __syncwarp();
  }

  // The four token phases' sums of each column.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 8);
      acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], 16);
    }
  }

  // The self-term, then acc / l.
  float kn[16], vn[16];
  const long nrow = ((long)b * p.Hkv + h) * kHeadDim + c0;
  bf16x16_to_float(p.k_new + nrow, kn);
  bf16x16_to_float(p.v_new + nrow, vn);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= p.G) break;
    float dot = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) dot = fmaf(qf[r][j], kn[j], dot);
    const float s_self = row_sum(dot) * p.scale;
    const float m_next = fmaxf(m[r], s_self);
    const float al = expf(m[r] - m_next);
    const float p_self = expf(s_self - m_next);
    const float l_r = al * l[r] + p_self;
    const float l_inv = l_r == 0.0f ? 0.0f : 1.0f / l_r;
    if (grp == 0) {
      uint32_t w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 two = __floats2bfloat162_rn(
            (acc[r][2 * j] * al + p_self * vn[2 * j]) * l_inv,
            (acc[r][2 * j + 1] * al + p_self * vn[2 * j + 1]) * l_inv);
        w[j] = *reinterpret_cast<const uint32_t*>(&two);
      }
      uint4* dst = reinterpret_cast<uint4*>(p.out + ((long)b * p.Hq + h * p.G + r) * kHeadDim + c0);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

// kPaired false: K10, one slot a block (P = 1). True: K11, P slots a block.
// The warps of a block take the block's units (slot, kv head), slot-major,
// in turn.
template <bool kPaired>
__global__ void __launch_bounds__(kMaxWarps * 32) paged_attn_grouped_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int P = kPaired ? p.P : 1;
  float* s_w = smem + (size_t)warp * (kRows + 1) * p.stride;
  for (int u = warp; u < P * p.Hkv; u += warps) {
    const int b = blockIdx.x * P + u / p.Hkv;
    if (b < p.B) attend_unit(p, b, u % p.Hkv, s_w);
  }
}

template <bool kPaired>
int launch(Params p, cudaStream_t stream) {
  p.stride = p.bk + 4;  // rows of a warp's scores 4 floats apart: no bank conflicts
  const size_t per_warp = (size_t)(kRows + 1) * p.stride * sizeof(float);
  const int units = p.P * p.Hkv;
  const int fit = (int)(kMaxSmem / per_warp);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int max_warps = min(kMaxWarps, fit);
  const int rounds = (units + max_warps - 1) / max_warps;
  const int warps = (units + rounds - 1) / rounds;  // the units spread evenly
  const size_t smem = warps * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attn_grouped_kernel<kPaired>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p.B + p.P - 1) / p.P;
  paged_attn_grouped_kernel<kPaired><<<blocks, warps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int run(const void* q, void* out, const void* pool, const void* scales, const void* page_table,
        const void* lengths, const void* q_offs, const void* k_new, const void* v_new, int B,
        int Hq, int Hkv, int ps, int pps, int pages_per_block, int page_offset, int window,
        int pair, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kRows || ps <= 0 || pps <= 0 || pages_per_block <= 0 ||
      pair <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.pool = static_cast<const int8_t*>(pool);
  p.scales = static_cast<const float*>(scales);
  p.page_table = static_cast<const int32_t*>(page_table);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.q_offs = static_cast<const int32_t*>(q_offs);
  p.k_new = static_cast<const __nv_bfloat16*>(k_new);
  p.v_new = static_cast<const __nv_bfloat16*>(v_new);
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.ps = ps;
  p.pps = pps;
  p.bk = min(pages_per_block, pps) * ps;
  p.page_offset = page_offset;
  p.window = window;
  p.P = pair;
  p.scale = scale;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pair == 1 ? launch<false>(p, s) : launch<true>(p, s);
}

}  // namespace

// K10: one block a slot. q, out [B, Hq, D] bf16 (S = 1); pool [N, Hkv, 2 * ps,
// D] int8 (KV-fused); scales [N, Hkv, 2 * ps] f32; page_table [B, pps],
// lengths, q_offs [B] int32; k_new, v_new [B, Hkv, D] bf16. Head dim 128,
// Hq / Hkv <= 4; window 0: none.
extern "C" int vzt_paged_attn_batched(const void* q, void* out, const void* pool,
                                      const void* scales, const void* page_table,
                                      const void* lengths, const void* q_offs, const void* k_new,
                                      const void* v_new, int B, int Hq, int Hkv, int ps, int pps,
                                      int pages_per_block, int page_offset, int window,
                                      float scale, void* stream) {
  return run(q, out, pool, scales, page_table, lengths, q_offs, k_new, v_new, B, Hq, Hkv, ps, pps,
             pages_per_block, page_offset, window, 1, scale, stream);
}

// K11: one block for each `pair` consecutive slots (pair >= 2; the last group
// may be short). Arguments as K10's.
extern "C" int vzt_paged_attn_paired(const void* q, void* out, const void* pool,
                                     const void* scales, const void* page_table,
                                     const void* lengths, const void* q_offs, const void* k_new,
                                     const void* v_new, int B, int Hq, int Hkv, int ps, int pps,
                                     int pages_per_block, int page_offset, int window, int pair,
                                     float scale, void* stream) {
  if (pair < 2) return static_cast<int>(cudaErrorInvalidValue);
  return run(q, out, pool, scales, page_table, lengths, q_offs, k_new, v_new, B, Hq, Hkv, ps, pps,
             pages_per_block, page_offset, window, pair, scale, stream);
}
