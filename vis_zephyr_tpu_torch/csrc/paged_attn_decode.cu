// K3 paged_attn_decode: attention of S query rows per slot over a KV cache
// kept as fixed-size pages in shared pools (bf16 or int8 with per-row scales,
// K and V in two pools or fused in one), with the current token folded in as
// a last online-softmax term.
//
// Replaces the TPU kernels `vis_zephyr_tpu/ops/paged_attention.py::_fa_mh_kernel`
// (:604) and `::_fa_gmh_kernel` (:911), one function, `paged_attention_fa`
// (:1218), under two TPU schedules; `::_fa_kernel` (:417), the same function on
// the TPU's (slot, kv head) grid (`fold_heads=False`); and `::_make_kernel`
// (:109), the single-row entry `paged_attention` (:229) over split pools with
// the self-term. All four are this kernel with S = 1 or more rows: the TPU
// folded the kv heads into one grid cell to divide a fixed cost per cell
// (`paged_attention.py:1286-1305`), which a CUDA block does not pay in the
// same way. Same arithmetic:
// - scores s = (q . k) * scale * (k_scale / 127.5), the dot summed in f32 (the
//   int8 -> bf16 convert is exact); mask slot <= qpos, slot < length and
//   slot > qpos - window; a masked score is -0.7 * FLT_MAX;
// - l sums the f32 probabilities; the probabilities that enter P.V are first
//   multiplied by v_scale / 127.5 and rounded to bf16; P.V summed in f32;
// - the self-term (k_new, v_new: the token being decoded, not yet in the
//   pool) is folded in last, in f32 and unquantized even over int8 pools;
// - a row with no key at all writes exact zeros.
// Rounding per split: a probability is rounded to bf16 against the running
// maximum of the warp and split that owns its key (below), not of all the
// slot's keys. The JAX kernels round against a running maximum per block of
// pages too, so this departs from nothing in the reference; the plain
// version rounds against the slot's maximum, within the smoke's gates.
//
// Port layout: pools [N, Hkv, rows, D] with N = layers * pages, rows = ps
// (split pools) or 2 * ps (fused: K rows then V rows of the page); scales
// [N, Hkv, rows] f32. `page_offset` (layer * pages) is added to every table
// entry, so one table serves all layers without a copy per layer. One (page,
// kv head) is one contiguous run of rows.
//
// What bounds it on the H100: bytes. A decode step reads every valid K and V
// row of every slot once per layer and does 4 * G * S multiply-adds per byte
// of int8 KV, far under the card's operations-per-byte line. The work comes
// in small units: a (slot, kv head) of the served 32-slot step holds about 3
// pages, so a block a unit walking its pages one after the other leaves most
// SMs idle and every page's load exposed.
//
// What the design does about it:
// - Splits (flash-decoding). The grid is (split, kv head, row tile, slot),
//   one dimension. The wrapper sets the number of splits from shapes only
//   (`ops/paged_attention.py::split_plan`: enough blocks for two on every
//   SM); each block takes an even share of its unit's valid pages, found in
//   the kernel from `lengths`, `q_offs`, the window and the tile's last query
//   row. A block of one split finishes its rows itself. With several, each
//   block writes its f32 partial (m, l and the accumulator of each row) to
//   scratch, and the last block of a unit to finish (an atomic count per
//   unit, left at zero) merges the partials in split order, skipping those
//   that hold no key (l = 0; a split without a page writes m = -inf, l = 0),
//   then folds in the self-term. No float atomics: the result repeats bit
//   for bit.
// - Pages by TMA into a ring. A producer warp reads the split's table entries
//   ahead (a warp of them at once) and keeps up to three pages (int8; two
//   for bf16, whose pages are twice as large) in flight: a stage holds 128
//   keys of one (page, kv head), K and V by 2-d tensor maps over the pools
//   (boxes of 32 rows, 128 bytes wide, 128-byte swizzled), only the boxes
//   that hold rows below `length`, and the scales by bulk copy. Four consumer
//   warps take 32 keys of each stage and free it on an mbarrier.
// - Both products on tensor cores, mma.sync m16n8k16 (bf16 in, f32 sums). The
//   narrow side, the tile's S * G query rows, is mma's M, padded to 16 or 32
//   (4 rows at decode, 20 at S = 5); wgmma would pad it to 64 and needs V's
//   transpose in shared memory in bf16, where mma.sync keeps the score
//   fragment as P.V's A fragment in registers and lets each warp run its own
//   online softmax over its keys. S = Q.K^T takes the keys as N: the 16-wide
//   k-step j of lane quad t holds d = 32t + 4j .. + 3 (int8; bf16 permutes
//   whole chunks), so a thread reads its K bytes as two 16-byte loads a key
//   row, conflict-free under the swizzle, and Q's fragments (built once in
//   shared memory) follow the same order. P.V takes d as N with column c of
//   n-tile jn at d = 16c + jn (bf16 swaps the halves of odd columns), so a
//   thread's V bytes are one 16-byte chunk of each of its four key rows.
//   int8 K and V become bf16 in registers exactly (|v| <= 128) by K5's bit
//   trick (`quant_matmul_int8.cu`): offset binary by an xor, `prmt` into
//   the low byte of the f32 2^23, minus 2^23 + 128, no I2F.
// - Rows at or past `length`: a box may bring them, and a stage's rows past
//   the boxes hold an older page. Their scores are replaced by the mask's
//   value and their probabilities by 0 by a select (so a NaN score or scale
//   never reaches the sums); bf16 V rows past `length` are zeroed in
//   registers before P.V (0 x NaN is NaN on a tensor core), int8 bytes are
//   finite.
// - Pages wholly after the tile's last query row, or wholly before the
//   window's first slot, are in no split.
// int8 pools need ps % 4 == 0 (16-byte scale rows for the bulk copy); any
// other shape K3 took before is taken.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kHeadDim = 128;
constexpr int kKeys = 128;                // keys a ring stage holds
constexpr int kWarps = 4;                 // 32 keys of a stage each
constexpr int kThreads = 32 * kWarps;     // lane 0 of warp 0 also issues the copies
constexpr int kBoxRows = 32;              // rows a TMA box brings
constexpr int kHalfBytes = kKeys * 128;   // a stage's 128-byte-wide column half of K or V
constexpr int kOStride = kHeadDim + 4;    // a merge-buffer row: column d at d + d / 32
constexpr float kNegInf = -0.7f * FLT_MAX;  // the TPU kernel's NEG_INF
constexpr float kInvQuantMax = 1.0f / 127.5f;
constexpr float kLog2e = 1.4426950408889634f;  // scores are kept in base 2: e^x = 2^(x log2 e)
constexpr uint32_t kFullMask = 0xffffffffu;

constexpr int kMaxSplits = 32;           // splits of a unit (the wrapper's plan keeps to it)

// A ring stage: K (kHalves swizzled column halves of 128 keys), V alike, then
// the K and V scales of int8 pools. int8 blocks of one m-tile (16 query rows:
// decode) hold a ring of two pages and run three to an SM, of two m-tiles
// three pages and two to an SM (their registers); bf16 two pages, one.
template <typename KV, int MT>
struct Pool {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kHalves = static_cast<int>(sizeof(KV));
  static constexpr int kRegion = kHalves * kHalfBytes;
  static constexpr int kStageBytes = 2 * kRegion + (kQuant ? 2 * kKeys * 4 : 0);  // 1024-aligned
  static constexpr int kStages = kQuant && MT == 2 ? 3 : 2;
  static constexpr int kBlocksPerSm = kQuant ? (MT == 1 ? 3 : 2) : 1;
};

// Dynamic shared memory of a block with MT m-tiles of 16 query rows.
template <typename KV, int MT>
struct Layout {
  static constexpr int kRows = 16 * MT;
  static constexpr int kRing = Pool<KV, MT>::kStages * Pool<KV, MT>::kStageBytes;
  static constexpr int kQf = kRing;                        // Q fragments [MT][8][32] of uint4
  static constexpr int kBars = kQf + MT * 8 * 32 * 16;     // full[kStages], empty[kStages]
  static constexpr int kMl = kBars + 16 * Pool<KV, MT>::kStages;  // (m, l) [kWarps][kRows]
  static constexpr int kSelf = kMl + kWarps * kRows * 8;   // self-term dots [kWarps + 1][kRows]
  static constexpr int kFlag = kSelf + (kWarps + 1) * kRows * 4;
  static constexpr int kAlloc = kFlag + 16 + 1024;          // + slack for 1024-byte alignment
  // Over the drained ring: the warps' accumulators [kWarps][kRows][kOStride]
  // f32, the splits' (m, l) [kMaxSplits][kRows] and their weights, the
  // warps' weights with each row's M and L [kRows][kWarps + 2].
  static constexpr int kSplitMl = kWarps * kRows * kOStride * 4;
  static constexpr int kSplitW = kSplitMl + kMaxSplits * kRows * 8;
  static constexpr int kBlockW = kSplitW + kMaxSplits * kRows * 4;
  static_assert(kBlockW + kRows * (kWarps + 2) * 4 <= kRing, "merge buffers exceed the ring");
};

struct Params {
  const __nv_bfloat16* q;      // [B, S, Hq, D]
  __nv_bfloat16* out;          // [B, S, Hq, D]
  const float* k_scales;       // [N, Hkv, rows] or null (bf16 pools)
  const float* v_scales;       // the same pointer when fused
  const int32_t* page_table;   // [B, pps]
  const int32_t* lengths;      // [B] tokens of the slot that are in the pool
  const int32_t* q_offs;       // [B] position of query row 0
  const __nv_bfloat16* k_new;  // [B, Hkv, D] or null
  const __nv_bfloat16* v_new;
  float* ws_o;                 // [units, splits, rows of a tile, D] f32 (splits > 1)
  float* ws_ml;                // [units, splits, rows of a tile, 2]: m, l
  int* counters;               // [units], zero; left zero
  int S, Hq, Hkv, G;
  int ps, pps, rows, v_row0;   // v_row0: first V row of a (page, head) (ps when fused)
  int page_offset;
  int window;                  // 0: no sliding window
  int tiles, splits;
  float scale;
};

// The pages [first, end) that split `split` of a tile walks: the valid pages
// of its unit (below `length`, none wholly after the tile's last query row or
// wholly before the window of its first), in even shares, in order.
// `ops/paged_attention.py::SplitPlan.pages` is the same arithmetic.
__device__ __forceinline__ void split_pages(const Params& p, int length, int q_off, int row0,
                                            int rows_here, int split, int& first, int& end) {
  int n_pages = min((length + p.ps - 1) / p.ps, p.pps);
  const int last_pos = q_off + (row0 + rows_here - 1) / p.G;
  n_pages = min(n_pages, last_pos < 0 ? 0 : last_pos / p.ps + 1);
  int lo = 0;
  if (p.window > 0) {
    const int w0 = q_off + row0 / p.G - (p.window - 1);
    lo = w0 > 0 ? w0 / p.ps : 0;
  }
  const int valid = max(0, n_pages - lo);
  const int share = (valid + p.splits - 1) / p.splits;
  first = min(lo + split * share, lo + valid);
  end = min(first + share, lo + valid);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

// Bytes 0 and 2 of x, two int8 values, as an exact bf16 pair (byte 0 in the
// low half) without I2F: each half 0x4300 | (v & 127) is 128 + (v & 127)
// (exponent 2^7, v's low seven bits the mantissa), minus 128, or 256 where
// v's sign bit is set (0x4380); the difference is an integer of at most 8
// significant bits, so the bf16 subtraction is exact. Two lop3 and one sub.
__device__ __forceinline__ uint32_t bf16x2_of_s8_even(uint32_t x) {
  const uint32_t mag = (x & 0x007F007Fu) | 0x43004300u;
  const uint32_t off = (x & 0x00800080u) | 0x43004300u;
  uint32_t r;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(mag), "r"(off));
  return r;
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled half.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// How a pool's K bytes become the B fragments of S = Q.K^T, and Q's words the
// matching A fragments. k-step j of lane quad position t covers the four d
// from q_d0(j, t); `q_pair` turns Q's bf16 words (d0, d0 + 1) and (d0 + 2,
// d0 + 3) into the A fragment's low-k pair (a0 / a1) and high-k pair (a2 / a3).
template <typename KV>
struct Front;

template <>
struct Front<int8_t> {
  static constexpr int kKWords = 8;  // a thread's K words of a key row: chunks 2t, 2t + 1
  __device__ static __forceinline__ int q_d0(int j, int t) { return 32 * t + 4 * j; }
  // K word j holds d0 .. d0 + 3: the pairs are (d0, d0 + 2) and (d0 + 1, d0 + 3).
  __device__ static __forceinline__ void q_pair(uint32_t x, uint32_t y, uint32_t& lo,
                                                uint32_t& hi) {
    lo = __byte_perm(x, y, 0x5410u);
    hi = __byte_perm(x, y, 0x7632u);
  }
  __device__ static __forceinline__ void load_k(uint32_t (&w)[kKWords], const uint8_t* k, int kr,
                                                int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 x = lds128(k + swz(kr, 2 * t + h));
      w[4 * h] = x.x;
      w[4 * h + 1] = x.y;
      w[4 * h + 2] = x.z;
      w[4 * h + 3] = x.w;
    }
  }
  __device__ static __forceinline__ void k_frag(const uint32_t (&w)[kKWords], int j, uint32_t& b0,
                                                uint32_t& b1) {
    b0 = bf16x2_of_s8_even(w[j]);
    b1 = bf16x2_of_s8_even(w[j] >> 8);
  }
  // d of column c of P.V's n-tile jn.
  __device__ static __forceinline__ int v_col(int jn, int c) { return 16 * c + jn; }
};

template <>
struct Front<__nv_bfloat16> {
  static constexpr int kKWords = 16;  // chunks 4t + (r ^ 2 (t / 2)), r = 0..3
  __device__ static __forceinline__ int chunk(int t, int r) { return 4 * t + (r ^ ((t >> 1) << 1)); }
  __device__ static __forceinline__ int q_d0(int j, int t) { return 8 * chunk(t, j >> 1) + 4 * (j & 1); }
  __device__ static __forceinline__ void q_pair(uint32_t x, uint32_t y, uint32_t& lo,
                                                uint32_t& hi) {
    lo = x;
    hi = y;
  }
  __device__ static __forceinline__ void load_k(uint32_t (&w)[kKWords], const uint8_t* k, int kr,
                                                int t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = chunk(t, r);
      const uint4 x = lds128(k + (c >> 3) * kHalfBytes + swz(kr, c & 7));
      w[4 * r] = x.x;
      w[4 * r + 1] = x.y;
      w[4 * r + 2] = x.z;
      w[4 * r + 3] = x.w;
    }
  }
  __device__ static __forceinline__ void k_frag(const uint32_t (&w)[kKWords], int j, uint32_t& b0,
                                                uint32_t& b1) {
    b0 = w[2 * j];
    b1 = w[2 * j + 1];
  }
  __device__ static __forceinline__ int v_col(int jn, int c) {
    return 16 * c + 8 * ((jn >> 3) ^ (c & 1)) + (jn & 7);
  }
};

template <typename KV, int MT>
__global__ void __launch_bounds__(kThreads, Pool<KV, MT>::kBlocksPerSm)
    paged_attn_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using P = Pool<KV, MT>;
  using L = Layout<KV, MT>;
  using F = Front<KV>;
  constexpr int ST = P::kStages;
  constexpr int TR = L::kRows;
  constexpr bool kQuant = P::kQuant;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (vzt::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = vzt::smem_u32(smem);
  auto full = [&](int s) { return base + L::kBars + 8u * s; };
  auto empty = [&](int s) { return base + L::kBars + 8u * (ST + s); };

  int bid = blockIdx.x;
  const int split = bid % p.splits;
  bid /= p.splits;
  const int h = bid % p.Hkv;
  bid /= p.Hkv;
  const int tile = bid % p.tiles;
  const int b = bid / p.tiles;
  const int unit = (b * p.tiles + tile) * p.Hkv + h;
  const int n_rows = p.S * p.G;
  const int row0 = tile * TR;
  const int rows_here = min(TR, n_rows - row0);
  const int length = p.lengths[b];
  const int q_off = p.q_offs[b];
  int first, end;
  split_pages(p, length, q_off, row0, rows_here, split, first, end);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  auto q_row = [&](int tr) {  // the q / out row of tile row tr
    const int r = row0 + tr;
    return ((static_cast<long>(b) * p.S + r / p.G) * p.Hq + h * p.G + r % p.G) * kHeadDim;
  };

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      vzt::mbar_init(full(s), 1);
      vzt::mbar_init(empty(s), kWarps);
    }
    vzt::fence_barrier_init();
    vzt::tma_prefetch(&tm_k);
    vzt::tma_prefetch(&tm_v);
  }
  __syncthreads();

  // Warp 0 issues the copies, stage by stage in the consumers' order: the
  // next stage is keys [pc0, pc0 + 128) of table page ppg, whose entry it
  // holds in a lane of `mine` (the split's entries read a warp at a time).
  int ppg = first, pc0 = 0, cached = first, mine = 0;
  auto issue = [&](int s) {
    if (ppg - cached >= 32 || ppg == first) {
      cached = ppg;
      mine = lane < end - ppg ? p.page_table[static_cast<long>(b) * p.pps + ppg + lane] : 0;
    }
    const long entry = static_cast<long>(__shfl_sync(kFullMask, mine, ppg - cached)) + p.page_offset;
    const long row_k = (entry * p.Hkv + h) * p.rows;
    const int page_keys = min(p.ps, length - ppg * p.ps);
    if (lane == 0) {
      const int n_tok = min(kKeys, page_keys - pc0);
      const int boxes = (n_tok + kBoxRows - 1) / kBoxRows;
      const int sc = kQuant ? (n_tok + 3) & ~3 : 0;
      const uint32_t st = base + s * P::kStageBytes;
      vzt::mbar_expect_tx(full(s), 2 * boxes * P::kHalves * kBoxRows * 128 + 2 * sc * 4);
      for (int bx = 0; bx < boxes; ++bx) {
        const int rk = static_cast<int>(row_k + pc0 + bx * kBoxRows);
#pragma unroll
        for (int hf = 0; hf < P::kHalves; ++hf) {
          const uint32_t off = hf * kHalfBytes + bx * kBoxRows * 128;
          vzt::tma_load_2d(st + off, &tm_k, full(s), hf * 64, rk);
          vzt::tma_load_2d(st + P::kRegion + off, &tm_v, full(s), hf * 64, rk + p.v_row0);
        }
      }
      if constexpr (kQuant) {
        vzt::bulk_load(st + 2 * P::kRegion, p.k_scales + row_k + pc0, sc * 4, full(s));
        vzt::bulk_load(st + 2 * P::kRegion + kKeys * 4, p.v_scales + row_k + p.v_row0 + pc0,
                       sc * 4, full(s));
      }
    }
    __syncwarp();
    pc0 += kKeys;
    if (pc0 >= page_keys) {
      ++ppg;
      pc0 = 0;
    }
  };
  // The prologue's global reads all in flight at once: thread tid builds Q
  // fragment entries tid + 128k, which hold its own lane's rows at k-steps
  // j = warp + 4k (mod 8); the self-term's k_new at those d and v_new at
  // column tid. Then warp 0 reads the split's table entries and issues the
  // first stages, and the fragments are stored.
  constexpr int kPer = MT * 8 * 32 / kThreads;  // entries a thread builds
  const bool self = p.k_new != nullptr;
  const long new_row = (static_cast<long>(b) * p.Hkv + h) * kHeadDim;
  uint2 qa[kPer], qb[kPer], kn[kPer];
  float vn = 0.0f;  // v_new at column tid
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kThreads;
    const int tr = 16 * ((k * kThreads) >> 8) + (lane >> 2);
    const int d0 = F::q_d0((e >> 5) & 7, lane & 3);
    qa[k] = qb[k] = kn[k] = make_uint2(0u, 0u);
    if (tr < rows_here) qa[k] = *reinterpret_cast<const uint2*>(p.q + q_row(tr) + d0);
    if (tr + 8 < rows_here) qb[k] = *reinterpret_cast<const uint2*>(p.q + q_row(tr + 8) + d0);
    if (self) kn[k] = *reinterpret_cast<const uint2*>(p.k_new + new_row + d0);
  }
  if (self) vn = __bfloat162float(p.v_new[new_row + tid]);
  if (warp == 0) {
    for (int s = 0; s < ST && ppg < end; ++s) issue(s);
  }
  uint4* qf = reinterpret_cast<uint4*>(smem + L::kQf);
  float* self_s = reinterpret_cast<float*>(smem + L::kSelf);  // [kWarps][TR] partial dots
  float dot[MT][2] = {};
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    uint4 a;
    F::q_pair(qa[k].x, qa[k].y, a.x, a.z);
    F::q_pair(qb[k].x, qb[k].y, a.y, a.w);
    qf[tid + k * kThreads] = a;
    if (self) {
      // The self-term's q . k_new over this thread's d, in f32: the rows'
      // and k_new's bf16 pairs in the same order.
      uint32_t klo, khi;
      F::q_pair(kn[k].x, kn[k].y, klo, khi);
      const int m = (k * kThreads) >> 8;  // entry tid + 128k's m-tile (tid < 128)
      const uint32_t rows[2][2] = {{a.x, a.z}, {a.y, a.w}};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const uint32_t kw[2] = {klo, khi};
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          dot[m][hr] = fmaf(__uint_as_float(rows[hr][w] << 16), __uint_as_float(kw[w] << 16),
                            dot[m][hr]);
          dot[m][hr] = fmaf(__uint_as_float(rows[hr][w] & 0xffff0000u),
                            __uint_as_float(kw[w] & 0xffff0000u), dot[m][hr]);
        }
      }
    }
  }
  if (self) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dot[m][hr] += __shfl_xor_sync(kFullMask, dot[m][hr], 1);
        dot[m][hr] += __shfl_xor_sync(kFullMask, dot[m][hr], 2);
        if ((lane & 3) == 0) self_s[warp * TR + 16 * m + (lane >> 2) + 8 * hr] = dot[m][hr];
      }
  }
  __syncthreads();
  // The self-term's scores, in base 2 as every score here (the warps' dots
  // summed in order), read after the loop's barriers.
  const float scale2 = p.scale * kLog2e;
  float* s_self = self_s + kWarps * TR;
  if (self && tid < TR)
    s_self[tid] = ((self_s[tid] + self_s[TR + tid]) + (self_s[2 * TR + tid] + self_s[3 * TR + tid])) *
                  scale2;

  // Warp `warp`: keys [32 warp, 32 warp + 32) of every stage, its own online
  // softmax over them. Thread (g, t) holds rows 16m + g and + 8.
  const int g = lane >> 2, t = lane & 3;
  const int key0 = 32 * warp;
  float m_run[MT][2], l_run[MT][2], acc[MT][16][4];
  int qpos[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m_run[m][hr] = -INFINITY;
      l_run[m][hr] = 0.0f;
      qpos[m][hr] = q_off + (row0 + 16 * m + g + 8 * hr) / p.G;
    }
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][jn][k] = 0.0f;
  }
  const uint4* qf_lane = qf + lane;

  int i = 0;
  for (int pg = first; pg < end; ++pg) {
    const int page_keys = min(p.ps, length - pg * p.ps);
    for (int c0 = 0; c0 < page_keys; c0 += kKeys, ++i) {
      const int s = i % ST;
      const uint8_t* st = smem + s * P::kStageBytes;
      const int n_tok = min(kKeys, page_keys - c0);
      vzt::mbar_wait_spin(full(s), (i / ST) & 1);
      if (key0 < n_tok) {
        const int pos0 = pg * p.ps + c0 + key0;  // the position of the warp's first key

        // S = Q . K^T over the warp's four n-tiles of 8 keys.
        float sc[MT][4][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) sc[m][nt][k] = 0.0f;
        // (Rows of the stage at or past n_tok are computed too and masked
        // below: no branch inside the products.)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t kw[F::kKWords];
          F::load_k(kw, st, key0 + 8 * nt + g, t);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            uint32_t b0, b1;
            F::k_frag(kw, j, b0, b1);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const uint4 a = qf_lane[(m * 8 + j) * 32];
              vzt::mma_m16n8k16_bf16(sc[m][nt], a.x, a.y, a.z, a.w, b0, b1);
            }
          }
        }

        // The thread's keys: key0 + 8 nt + 2t + e; a score is the dot times
        // ksc (the softmax scale in base 2, times k_scale / 127.5 for int8).
        float ksc[4][2], vsc[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          ksc[nt][0] = ksc[nt][1] = scale2;
          vsc[nt][0] = vsc[nt][1] = 1.0f;
          if constexpr (kQuant) {
            const float* kscale = reinterpret_cast<const float*>(st + 2 * P::kRegion);
            const float2 kx = *reinterpret_cast<const float2*>(kscale + key0 + 8 * nt + 2 * t);
            const float2 vx =
                *reinterpret_cast<const float2*>(kscale + kKeys + key0 + 8 * nt + 2 * t);
            ksc[nt][0] = scale2 * (kx.x * kInvQuantMax);
            ksc[nt][1] = scale2 * (kx.y * kInvQuantMax);
            vsc[nt][0] = vx.x * kInvQuantMax;
            vsc[nt][1] = vx.y * kInvQuantMax;
          }
        }

        // Online softmax per row; P as bf16 A fragments of P.V's two k-steps.
        // Key position pos is valid for a row at qp when lo < pos < hi.
        const int stage_end = pg * p.ps + c0 + n_tok;  // the first position past the stage's keys
        const int my_pos = pos0 + 2 * t;               // + 8 nt + e
        uint32_t pa[MT][2][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float pv[4][4];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int qp = qpos[m][hr];
            const int hi = min(stage_end, qp + 1) - my_pos;
            const int lo = p.window > 0 ? qp - p.window - my_pos : -1;
            bool ok[4][2];
            float mx = kNegInf;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                ok[nt][e] = 8 * nt + e < hi && 8 * nt + e > lo;
                const float v = ok[nt][e] ? sc[m][nt][2 * hr + e] * ksc[nt][e] : kNegInf;
                sc[m][nt][2 * hr + e] = v;
                mx = fmaxf(mx, v);
              }
            mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
            const float m_next = fmaxf(m_run[m][hr], mx);
            const float alpha = vzt::ex2(m_run[m][hr] - m_next);
            m_run[m][hr] = m_next;
            float sum = 0.0f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float pe = ok[nt][e] ? vzt::ex2(sc[m][nt][2 * hr + e] - m_next) : 0.0f;
                sum += pe;
                pv[nt][2 * hr + e] = ok[nt][e] ? pe * vsc[nt][e] : 0.0f;
              }
            l_run[m][hr] = alpha * l_run[m][hr] + sum;
            if (__any_sync(kFullMask, alpha != 1.0f)) {  // a row's maximum moved
#pragma unroll
              for (int jn = 0; jn < 16; ++jn) {
                acc[m][jn][2 * hr] *= alpha;
                acc[m][jn][2 * hr + 1] *= alpha;
              }
            }
          }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            pa[m][ks][0] = vzt::pack_bf16x2(pv[2 * ks][0], pv[2 * ks][1]);
            pa[m][ks][1] = vzt::pack_bf16x2(pv[2 * ks][2], pv[2 * ks][3]);
            pa[m][ks][2] = vzt::pack_bf16x2(pv[2 * ks + 1][0], pv[2 * ks + 1][1]);
            pa[m][ks][3] = vzt::pack_bf16x2(pv[2 * ks + 1][2], pv[2 * ks + 1][3]);
          }
        }

        // O += P . V: k-step ks is keys key0 + 16 ks .. + 15; the thread's B
        // rows are vr[0], vr[1] (b0) and vr[2], vr[3] (b1), column g.
        const uint8_t* vreg = st + P::kRegion;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          {
            const int r0 = key0 + 16 * ks + 2 * t;
            const int vr[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
            if constexpr (kQuant) {
              // Byte jn of each row's chunk g is n-tile jn.
              uint4 w[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) w[e] = lds128(vreg + swz(vr[e], g));
              const uint32_t wa[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
              const uint32_t wb[4] = {w[1].x, w[1].y, w[1].z, w[1].w};
              const uint32_t wc[4] = {w[2].x, w[2].y, w[2].z, w[2].w};
              const uint32_t wd[4] = {w[3].x, w[3].y, w[3].z, w[3].w};
#pragma unroll
              for (int qw = 0; qw < 4; ++qw) {
                // Bytes (0, 2) of x pair rows vr[0], vr[1] at n-tile 4 qw, bytes
                // (1, 3) at 4 qw + 1; y the same at 4 qw + 2 and + 3.
                const uint32_t x0 = __byte_perm(wa[qw], wb[qw], 0x5410u);
                const uint32_t x1 = __byte_perm(wa[qw], wb[qw], 0x7632u);
                const uint32_t y0 = __byte_perm(wc[qw], wd[qw], 0x5410u);
                const uint32_t y1 = __byte_perm(wc[qw], wd[qw], 0x7632u);
                const uint32_t bb[4][2] = {
                    {bf16x2_of_s8_even(x0), bf16x2_of_s8_even(y0)},
                    {bf16x2_of_s8_even(x0 >> 8), bf16x2_of_s8_even(y0 >> 8)},
                    {bf16x2_of_s8_even(x1), bf16x2_of_s8_even(y1)},
                    {bf16x2_of_s8_even(x1 >> 8), bf16x2_of_s8_even(y1 >> 8)}};
#pragma unroll
                for (int u = 0; u < 4; ++u)
#pragma unroll
                  for (int m = 0; m < MT; ++m)
                    vzt::mma_m16n8k16_bf16(acc[m][4 * qw + u], pa[m][ks][0], pa[m][ks][1],
                                           pa[m][ks][2], pa[m][ks][3], bb[u][0], bb[u][1]);
              }
            } else {
              // Chunks 2g and 2g + 1 of each row, the odd g's in the other
              // order (conflict-free); chunk slot hh is n-tiles 8 hh .. + 7.
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int c = 2 * g + (hh ^ (g & 1));
                uint32_t w[4][4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  uint4 x = lds128(vreg + (c >> 3) * kHalfBytes + swz(vr[e], c & 7));
                  if (vr[e] >= n_tok) x = make_uint4(0u, 0u, 0u, 0u);  // may hold NaN
                  w[e][0] = x.x;
                  w[e][1] = x.y;
                  w[e][2] = x.z;
                  w[e][3] = x.w;
                }
#pragma unroll
                for (int el = 0; el < 8; ++el) {
                  const uint32_t sel = (el & 1) ? 0x7632u : 0x5410u;
                  const uint32_t b0 = __byte_perm(w[0][el >> 1], w[1][el >> 1], sel);
                  const uint32_t b1 = __byte_perm(w[2][el >> 1], w[3][el >> 1], sel);
#pragma unroll
                  for (int m = 0; m < MT; ++m)
                    vzt::mma_m16n8k16_bf16(acc[m][8 * hh + el], pa[m][ks][0], pa[m][ks][1],
                                           pa[m][ks][2], pa[m][ks][3], b0, b1);
                }
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) vzt::mbar_arrive(empty(s));
      if (warp == 0 && ppg < end) {
        // Refill the slot once every warp has freed it.
        vzt::mbar_wait(empty(s), (i / ST) & 1);
        issue(s);
      }
    }
  }

  // The warps' partials into shared memory (over the drained ring: every
  // stage issued was waited for), then thread tid owns column d = tid.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l_run[m][hr] += __shfl_xor_sync(kFullMask, l_run[m][hr], 1);
      l_run[m][hr] += __shfl_xor_sync(kFullMask, l_run[m][hr], 2);
    }
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(smem);             // [kWarps][TR][kOStride]
  float* ml_s = reinterpret_cast<float*>(smem + L::kMl);   // [kWarps][TR][2]
  int* flag_s = reinterpret_cast<int*>(smem + L::kFlag);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int tr = 16 * m + g + 8 * hr;
      if (t == 0) {
        ml_s[(warp * TR + tr) * 2] = m_run[m][hr];
        ml_s[(warp * TR + tr) * 2 + 1] = l_run[m][hr];
      }
#pragma unroll
      for (int jn = 0; jn < 16; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int dd = F::v_col(jn, 2 * t + e);
          o_s[(warp * TR + tr) * kOStride + dd + (dd >> 5)] = acc[m][jn][2 * hr + e];
        }
    }
  __syncthreads();

  // The warps merged in order; thread tid owns column d = tid of every row.
  // A partial that holds no key (l = 0) is skipped, never scaled: M is the
  // largest m of the others (-inf, with L = O = 0, when none holds a key).
  const int d = tid;
  // Row tr's M and L, and each warp's weight (0 for one without a key), by
  // thread tr; then each column's sum.
  float* wt_s = reinterpret_cast<float*>(smem + L::kBlockW);  // [TR][kWarps + 2]: w, M, L
  if (tid < rows_here) {
    float M = -INFINITY, Ls = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (ml_s[(w * TR + tid) * 2 + 1] > 0.0f) M = fmaxf(M, ml_s[(w * TR + tid) * 2]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = ml_s[(w * TR + tid) * 2 + 1];
      const float f = lw > 0.0f ? vzt::ex2(ml_s[(w * TR + tid) * 2] - M) : 0.0f;
      Ls += lw * f;
      wt_s[tid * (kWarps + 2) + w] = f;
    }
    wt_s[tid * (kWarps + 2) + kWarps] = M;
    wt_s[tid * (kWarps + 2) + kWarps + 1] = Ls;
  }
  __syncthreads();
  auto block_merge = [&](int tr, float& M, float& Ls, float& Os) {
    const float* wt = wt_s + tr * (kWarps + 2);
    Os = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (wt[w] > 0.0f) Os += o_s[(w * TR + tr) * kOStride + d + (d >> 5)] * wt[w];
    M = wt[kWarps];
    Ls = wt[kWarps + 1];
  };
  // The self-term last, in f32, then out = O / l (0 where l = 0).
  auto finish = [&](int tr, float M, float l, float o) {
    if (self) {
      const float m_next = fmaxf(M, s_self[tr]);
      const float alpha = vzt::ex2(M - m_next);
      const float p_self = vzt::ex2(s_self[tr] - m_next);
      l = alpha * l + p_self;
      o = o * alpha + p_self * vn;
    }
    const float l_inv = l == 0.0f ? 0.0f : 1.0f / l;
    p.out[q_row(tr) + d] = __float2bfloat16_rn(o * l_inv);
  };

  if (p.splits == 1) {
#pragma unroll 4
    for (int tr = 0; tr < rows_here; ++tr) {
      float M, L, O;
      block_merge(tr, M, L, O);
      finish(tr, M, L, O);
    }
    return;
  }
  // This split's partial to scratch; the unit's last block merges them all
  // in split order.
  const long mine_row = (static_cast<long>(unit) * p.splits + split) * TR;
#pragma unroll 1
  for (int tr = 0; tr < rows_here; ++tr) {
    float M, L, O;
    block_merge(tr, M, L, O);
    __stcg(p.ws_o + (mine_row + tr) * kHeadDim + d, O);
    if (d == 0) __stcg(reinterpret_cast<float2*>(p.ws_ml) + mine_row + tr, make_float2(M, L));
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag_s = atomicAdd(p.counters + unit, 1) == p.splits - 1;
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  // Every split's (m, l) at once, then each row's M, L and the splits'
  // weights (0 for a split without a key), then each column's sum.
  const long all = static_cast<long>(unit) * p.splits * TR;
  float2* sml = reinterpret_cast<float2*>(smem + L::kSplitMl);  // [splits][TR]
  float* sw = reinterpret_cast<float*>(smem + L::kSplitW);      // [splits][TR]
  for (int k = tid; k < p.splits * TR; k += kThreads)
    sml[k] = __ldcg(reinterpret_cast<const float2*>(p.ws_ml) + all + k);
  __syncthreads();
  if (tid < rows_here) {
    float M = -INFINITY, Ls = 0.0f;
    for (int sp = 0; sp < p.splits; ++sp)
      if (sml[sp * TR + tid].y > 0.0f) M = fmaxf(M, sml[sp * TR + tid].x);
    for (int sp = 0; sp < p.splits; ++sp) {
      const float2 x = sml[sp * TR + tid];
      const float f = x.y > 0.0f ? vzt::ex2(x.x - M) : 0.0f;
      Ls += x.y * f;
      sw[sp * TR + tid] = f;
    }
    sml[tid] = make_float2(M, Ls);  // split 0's entry is read no more
  }
  __syncthreads();
#pragma unroll 1
  for (int tr = 0; tr < rows_here; ++tr) {
    const float* o = p.ws_o + (all + tr) * kHeadDim + d;
    float Os = 0.0f;
#pragma unroll 4
    for (int sp = 0; sp < p.splits; ++sp) {
      const float f = sw[sp * TR + tr];
      if (f > 0.0f) Os += __ldcg(o + static_cast<long>(sp) * TR * kHeadDim) * f;
    }
    finish(tr, sml[tr].x, sml[tr].y, Os);
  }
  if (tid == 0) p.counters[unit] = 0;
}

template <typename KV, int MT>
int launch(const CUtensorMap& tm_k, const CUtensorMap& tm_v, const Params& p, int B,
           cudaStream_t stream) {
  using L = Layout<KV, MT>;
  cudaError_t err = cudaFuncSetAttribute(paged_attn_decode_kernel<KV, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long blocks = static_cast<long>(B) * p.tiles * p.Hkv * p.splits;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  paged_attn_decode_kernel<KV, MT><<<static_cast<unsigned>(blocks), kThreads, L::kAlloc, stream>>>(
      tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

// A map over a pool [N, Hkv, rows, 128] as 2-d rows of 128 values, boxes of
// kBoxRows rows and 128 bytes (one box of int8, half a row of bf16).
template <typename KV>
int pool_map(CUtensorMap* map, const void* pool, long total_rows) {
  if (total_rows > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  return sizeof(KV) == 1
             ? vzt::make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, pool,
                                static_cast<int>(total_rows), kHeadDim, kHeadDim, 128, kBoxRows,
                                CU_TENSOR_MAP_SWIZZLE_128B)
             : vzt::make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, pool,
                                static_cast<int>(total_rows), kHeadDim, 2 * kHeadDim, 64,
                                kBoxRows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename KV>
int run(const void* k_pool, const void* v_pool, long total_rows, const Params& p, int B,
        int tile_rows, cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  int code = pool_map<KV>(&tm_k, k_pool, total_rows);
  if (code == 0) {
    if (v_pool == k_pool) {
      tm_v = tm_k;
    } else {
      code = pool_map<KV>(&tm_v, v_pool, total_rows);
    }
  }
  if (code != 0) return code;
  return tile_rows == 16 ? launch<KV, 1>(tm_k, tm_v, p, B, stream)
                         : launch<KV, 2>(tm_k, tm_v, p, B, stream);
}

}  // namespace

// kv_int8: 1 for int8 pools (scales given), 0 for bf16 pools. v_pool/v_scales
// null: fused pools (V rows follow the K rows inside each page). N: pool
// entries (k_pool's first dim). Head dim 128 (the wrapper checks it); any
// S >= 1. tile_rows (16 if S * Hq / Hkv <= 16, else 32) and splits are the
// wrapper's `split_plan`; with splits > 1, ws_o is f32 [units, splits,
// tile_rows, 128], ws_ml f32 [units, splits, tile_rows, 2] and counters int32
// [units], zero (left zero), units = B * tiles * Hkv.
extern "C" int vzt_paged_attn_decode(const void* q, void* out, const void* k_pool,
                                     const void* v_pool, const void* k_scales,
                                     const void* v_scales, const void* page_table,
                                     const void* lengths, const void* q_offs, const void* k_new,
                                     const void* v_new, void* ws_o, void* ws_ml, void* counters,
                                     int B, int S, int Hq, int Hkv, int N, int ps, int pps,
                                     int page_offset, int window, int kv_int8, int tile_rows,
                                     int splits, float scale, void* stream) {
  const bool fused = v_pool == nullptr;
  if (S < 1 || Hkv < 1 || Hq % Hkv != 0 || ps < 1 || pps < 1 || splits < 1 ||
      splits > kMaxSplits ||
      tile_rows != (S * (Hq / Hkv) <= 16 ? 16 : 32) || (kv_int8 && ps % 4 != 0) ||
      (splits > 1 && (ws_o == nullptr || ws_ml == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = fused ? p.k_scales : static_cast<const float*>(v_scales);
  p.page_table = static_cast<const int32_t*>(page_table);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.q_offs = static_cast<const int32_t*>(q_offs);
  p.k_new = static_cast<const __nv_bfloat16*>(k_new);
  p.v_new = static_cast<const __nv_bfloat16*>(v_new);
  p.ws_o = static_cast<float*>(ws_o);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.counters = static_cast<int*>(counters);
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
  p.tiles = (S * p.G + tile_rows - 1) / tile_rows;
  p.splits = splits;
  p.scale = scale;
  const long total_rows = static_cast<long>(N) * Hkv * p.rows;
  const void* v = fused ? k_pool : v_pool;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kv_int8 ? run<int8_t>(k_pool, v, total_rows, p, B, tile_rows, s)
                 : run<__nv_bfloat16>(k_pool, v, total_rows, p, B, tile_rows, s);
}
