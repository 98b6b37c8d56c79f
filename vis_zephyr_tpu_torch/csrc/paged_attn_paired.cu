// K11 paged_attn_paired: decode attention (one query row a slot, S = 1) over
// KV-fused int8 page pools with the current token folded in last, launched
// for groups of P consecutive slots, rebuilt for Hopper.
//
// Replaces the TPU kernel `experiments/paired_slot_attention_probe.py::
// _paired_kernel` (:28, wrapper `fa_paired`: one grid cell per P slots, the
// group's blocks of pages walked in step). It computes K10's function
// (`paged_attn_grouped.cu`, plain version `ops/paged_attention.py::
// paged_attention_grouped_plain`):
// - scores s = (q . kq) * scale * (k_scale / 127.5), the dot summed in f32
//   (int8 -> bf16 is exact); a slot's keys are [max(0, qpos - window + 1),
//   min(length, qpos + 1)) with qpos = q_offs[b];
// - the online softmax steps over blocks of bk = min(pages_per_block, pps) *
//   ps tokens numbered from token 0: m and l are updated once a block, and
//   the probabilities that enter P.V are exp(s - m) against the running
//   maximum after the block, times v_scale / 127.5, rounded to bf16;
// - the self-term (k_new, v_new) folded in last, in f32 and unquantized; then
//   acc / l, rounded to bf16.
// P sets which slots a group holds, not the numbers: each slot's arithmetic
// is K10's. Where a slot's walk is split (below), each split runs that
// online softmax over its own blocks from a fresh maximum and the splits are
// merged in split order, so the bf16 rounding of a split's probabilities
// falls against its own running maximum; the plain version's `splits`
// argument does the same.
//
// Port layout: pool [N, Hkv, 2 * ps, D] int8 (a page's K rows, then its V
// rows), scales [N, Hkv, 2 * ps] f32, page table [B, pps] of within-layer ids
// plus `page_offset`.
//
// What bounds it on the H100: bytes. At the probes' bench shape (128 slots
// of 640 tokens, Hkv = 8, D = 128) a layer reads 173 MB of KV and scales,
// 0.0524 ms at 3.35 TB/s, for 1.3 GFLOP.
//
// What the design does about it (the earlier design, eight warps of one
// block walking the P slots of a group one after the other with fmaf
// products and plain loads, is kept in `paged_attn_grouped.cu` as
// `vzt_paged_attn_paired_walk` for the probes to time):
// - The grid does not shrink with P. A block is one (slot, kv head, split)
//   unit of four warps; the blocks of a group's P * Hkv units are adjacent in
//   launch order (the group is what P names), and the grid holds every unit
//   of every group. Where the units leave block slots of the card idle, a
//   slot's walk is split at bk boundaries (`ops/paged_attention.py::
//   paired_plan`, from shapes only): each split takes an even share of the
//   slot's valid blocks, writes its f32 partial (m, l, acc of each row) to
//   scratch, and the unit's last block to finish (an atomic count, left at
//   zero) merges them in split order, skipping those without a key, then
//   folds in the self-term. No float atomics: the result repeats bit for bit.
// - Pages by TMA into an mbarrier ring. A stage is 128 keys of one (page, kv
//   head), K rows or V rows (2-d tensor map over the pool, boxes of 32 rows
//   of 128 bytes, 128-byte swizzled, only the boxes that hold rows of the
//   block) with their scales by bulk copy. A block's stages run K of its
//   pages, then V of the same pages, so the ring (three stages, two where the
//   scores leave no room) loads the V rows while the last K rows are scored,
//   and each byte is read once. Lane 0 of warp 0 issues the copies and
//   refills a stage once the four warps have freed it.
// - Both products on mma.sync m16n8k16 (bf16 in, f32 sums), K3's fragments
//   (`paged_attn_decode.cu`): S = Q.K^T takes the G <= 4 query rows as M
//   (padded to 16) and each warp's 32 keys of a stage as N; P.V takes the
//   keys as K and d as N. int8 K and V become bf16 in registers by two lop3
//   and a bf16x2 subtraction, no I2F. The block's scores go to shared memory
//   (4 rows of bk floats): its maximum is known only once every K stage of
//   the block is scored, and the V stages then turn them into probabilities.
// - Keys at or past a block's end are never scored or used: a stage's rows
//   past the loaded boxes hold older bytes (finite int8) and their scales may
//   be anything, so scores, probabilities and scales pass through selects.
// int8 pools with ps % 4 == 0 (16-byte scale rows for the bulk copy).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kHeadDim = 128;
constexpr int kRows = 4;                   // query rows a unit holds: G <= 4
constexpr int kKeys = 128;                 // keys a ring stage holds
constexpr int kWarps = 4;                  // 32 keys of a stage each
constexpr int kThreads = 32 * kWarps;      // thread tid also owns column d = tid at the end
constexpr int kBoxRows = 32;               // rows a TMA box brings
constexpr int kDataBytes = kKeys * 128;    // a stage's rows: 16 KB
constexpr int kStageBytes = kDataBytes + kKeys * 4;  // with its scales
constexpr int kMaxStages = 3;
constexpr int kMaxSplits = 32;             // the wrapper's plan keeps to it
constexpr int kOStride = kHeadDim + 4;     // a merge-buffer row: column d at d + d / 32
constexpr size_t kMaxSmem = 232448;        // 227 KB a block
constexpr float kNegInf = -0.7f * FLT_MAX;  // the TPU kernels' NEG_INF
constexpr float kInvQuantMax = 1.0f / 127.5f;
constexpr float kLog2e = 1.4426950408889634f;  // scores are kept in base 2
constexpr uint32_t kFullMask = 0xffffffffu;

// The fixed region after the ring (byte offsets from its start).
constexpr int kQf = 0;                            // Q fragments [8][32] of uint4
constexpr int kBars = kQf + 8 * 32 * 16;          // full[kMaxStages], empty[kMaxStages]
constexpr int kWmax = kBars + 16 * kMaxStages;    // a block's maxima [kWarps][kRows]
constexpr int kMrow = kWmax + kWarps * kRows * 4;  // each row's running maximum [kRows]
constexpr int kSelf = kMrow + kRows * 4;          // self-term dots [kWarps + 1][kRows]
constexpr int kLsum = kSelf + (kWarps + 1) * kRows * 4;  // the warps' l [kWarps][kRows]
constexpr int kSml = kLsum + kWarps * kRows * 4;  // the splits' (m, l) [kMaxSplits][kRows]
constexpr int kSw = kSml + kMaxSplits * kRows * 8;  // their weights [kMaxSplits][kRows]
constexpr int kFlag = kSw + kMaxSplits * kRows * 4;
constexpr int kScores = 6144;                     // the block's scores [kRows][bk] f32
static_assert(kFlag + 16 <= kScores, "the fixed region overflows");
static_assert(kWarps * kRows * kOStride * 4 <= 2 * kStageBytes, "merge buffer exceeds the ring");

// Dynamic shared memory of a block: the 1024-byte alignment slack, the ring,
// the fixed region and the scores. `ops/paged_attention.py::paired_smem` is
// the same sum.
size_t smem_bytes(int bk, int stages) {
  return 1024 + static_cast<size_t>(stages) * kStageBytes + kScores +
         static_cast<size_t>(kRows) * bk * 4;
}

struct Params {
  const __nv_bfloat16* q;      // [B, Hq, D]
  __nv_bfloat16* out;          // [B, Hq, D]
  const float* scales;         // [N, Hkv, 2 * ps]
  const int32_t* page_table;   // [B, pps]
  const int32_t* lengths;      // [B] tokens of the slot in the pool
  const int32_t* q_offs;       // [B] the query's position
  const __nv_bfloat16* k_new;  // [B, Hkv, D]
  const __nv_bfloat16* v_new;
  float* ws_o;                 // [units, splits, kRows, D] f32 (splits > 1)
  float* ws_ml;                // [units, splits, kRows, 2]: m, l
  int* counters;               // [units], zero; left zero
  int B, Hq, Hkv, G, ps, pps, bk, page_offset, window, P, splits, stages;
  float scale;
};

// The bk-blocks [first, end) that split `split` of a slot walks: the blocks
// that hold a key of [lo, hi), in even shares of ceil(n / splits), in order.
// `ops/paged_attention.py::paired_split_blocks` is the same arithmetic.
__device__ __forceinline__ void split_blocks(const Params& p, int lo, int hi, int split,
                                             int& first, int& end) {
  if (hi <= lo) {
    first = end = 0;
    return;
  }
  const int b0 = lo / p.bk, b1 = (hi + p.bk - 1) / p.bk;
  const int share = (b1 - b0 + p.splits - 1) / p.splits;
  first = min(b0 + split * share, b1);
  end = min(first + share, b1);
}

// Bytes 0 and 2 of x, two int8 values, as an exact bf16 pair (K3's
// `bf16x2_of_s8_even`): 0x4300 | (v & 127) minus 128, or 256 where v's sign
// bit is set; two lop3 and one sub.
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

// Byte offset of 16-byte chunk c (0..7) of row r in a 128-byte-swizzled stage.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__global__ void __launch_bounds__(kThreads, 3)
    paged_attn_paired_kernel(const __grid_constant__ CUtensorMap tm, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (vzt::smem_u32(smem_raw) & 1023u)) & 1023u);
  const int ST = p.stages;
  const uint32_t base = vzt::smem_u32(smem);
  uint8_t* fixed = smem + ST * kStageBytes;
  const uint32_t bars = base + ST * kStageBytes + kBars;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kMaxStages + s); };
  const float* scl = reinterpret_cast<const float*>(smem + ST * kDataBytes);  // [ST][kKeys]
  float* wmax = reinterpret_cast<float*>(fixed + kWmax);
  float* mrow = reinterpret_cast<float*>(fixed + kMrow);
  float* self_s = reinterpret_cast<float*>(fixed + kSelf);
  float* lsum = reinterpret_cast<float*>(fixed + kLsum);
  float* s_sm = reinterpret_cast<float*>(fixed + kScores);  // [kRows][bk]

  // Block order: the P members of a group side by side, then the kv heads,
  // the splits and the groups.
  int bid = blockIdx.x;
  const int member = bid % p.P;
  bid /= p.P;
  const int h = bid % p.Hkv;
  bid /= p.Hkv;
  const int split = bid % p.splits;
  const int b = (bid / p.splits) * p.P + member;
  if (b >= p.B) return;  // the last group's missing members
  const int unit = b * p.Hkv + h;
  const int G = p.G;
  const int ps = p.ps;
  const int bk = p.bk;
  const int length = p.lengths[b];
  const int q_off = p.q_offs[b];
  const int hi = min(min(length, q_off + 1), p.pps * ps);
  const int lo = p.window > 0 ? max(q_off - p.window + 1, 0) : 0;
  int first, end;
  split_blocks(p, lo, hi, split, first, end);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long q_base = (static_cast<long>(b) * p.Hq + h * G) * kHeadDim;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      vzt::mbar_init(full(s), 1);
      vzt::mbar_init(empty(s), kWarps);
    }
    vzt::fence_barrier_init();
    vzt::tma_prefetch(&tm);
  }
  __syncthreads();

  // Warp 0 issues the copies in the consumers' order: for each block of the
  // split, the K rows of its pages, then their V rows, 128 keys a stage. The
  // cursor is (block pb, K or V pkv, table page ppg, first key pc0); the
  // table entries are read a warp at a time into `mine`.
  int pb = first, pkv = 0, ppg = 0, pc0 = 0, cached = -64, mine = 0;
  if (first < end) ppg = max(first * bk, lo) / ps;
  auto issue = [&](int s) {
    const int a = max(pb * bk, lo), e = min((pb + 1) * bk, hi);
    if (ppg < cached || ppg >= cached + 32) {
      cached = ppg;
      mine = cached + lane < p.pps ? p.page_table[static_cast<long>(b) * p.pps + cached + lane] : 0;
    }
    const long entry = static_cast<long>(__shfl_sync(kFullMask, mine, ppg - cached)) + p.page_offset;
    const long row = (entry * p.Hkv + h) * (2 * ps) + (pkv ? ps : 0) + pc0;
    const int pn = min(ps, e - ppg * ps);  // the page's keys inside the block
    if (lane == 0) {
      const int n_tok = min(kKeys, pn - pc0);
      const int boxes = (n_tok + kBoxRows - 1) / kBoxRows;
      const int sc = (n_tok + 3) & ~3;
      vzt::mbar_expect_tx(full(s), boxes * kBoxRows * 128 + sc * 4);
      for (int bx = 0; bx < boxes; ++bx)
        vzt::tma_load_2d(base + s * kDataBytes + bx * kBoxRows * 128, &tm, full(s), 0,
                         static_cast<int>(row + bx * kBoxRows));
      vzt::bulk_load(base + ST * kDataBytes + s * kKeys * 4, p.scales + row, sc * 4, full(s));
    }
    __syncwarp();
    pc0 += kKeys;
    if (pc0 >= pn) {
      pc0 = 0;
      if (++ppg > (e - 1) / ps) {
        if (pkv == 0) {
          pkv = 1;
          ppg = a / ps;
        } else {
          pkv = 0;
          if (++pb < end) ppg = max(pb * bk, lo) / ps;
        }
      }
    }
  };

  // Prologue: the Q fragments (K3's layout for int8 K, one m-tile: thread
  // tid builds entries tid and tid + 128, its lane's row at k-steps warp and
  // warp + 4), the self-term's dots (thread tid holds column d = tid of each
  // row, k_new and v_new), then warp 0 issues the first stages.
  uint4* qf = reinterpret_cast<uint4*>(fixed + kQf);
  const long new_row = (static_cast<long>(b) * p.Hkv + h) * kHeadDim;
  const float kn = __bfloat162float(p.k_new[new_row + tid]);
  const float vn = __bfloat162float(p.v_new[new_row + tid]);
  float qd[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    qd[r] = r < G ? __bfloat162float(p.q[q_base + r * kHeadDim + tid]) : 0.0f;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = warp + 4 * k;                 // the k-step of entry tid + 128k
    const int d0 = 32 * t + 4 * j;              // K3's `Front<int8_t>::q_d0`
    uint2 qa = make_uint2(0u, 0u);
    if (g < G) qa = *reinterpret_cast<const uint2*>(p.q + q_base + g * kHeadDim + d0);
    uint4 frag;
    frag.x = __byte_perm(qa.x, qa.y, 0x5410u);  // row g, the low-k pair
    frag.z = __byte_perm(qa.x, qa.y, 0x7632u);  // row g, the high-k pair
    frag.y = frag.w = 0u;                       // rows g + 8: padding
    qf[tid + k * kThreads] = frag;
  }
  if (warp == 0) {
    for (int s = 0; s < ST && pb < end; ++s) issue(s);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float dot = qd[r] * kn;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(kFullMask, dot, o);
    if (lane == 0) self_s[warp * kRows + r] = dot;
  }
  __syncthreads();
  const float scale2 = p.scale * kLog2e;
  const float s_self = ((self_s[0 * kRows + (tid & 3)] + self_s[1 * kRows + (tid & 3)]) +
                        (self_s[2 * kRows + (tid & 3)] + self_s[3 * kRows + (tid & 3)])) * scale2;
  // s_self of row tid & 3; thread tid needs each row's in the epilogue.
  if (tid < kRows) self_s[kWarps * kRows + tid] = s_self;

  // Thread (g, t) of warp w: row g (real when g < G) and keys 32w + 8nt + 2t
  // + e of every stage; acc holds its rows' columns (2t + e) of each n-tile.
  const int key0 = 32 * warp;
  const bool real = g < G;
  float m_run = -INFINITY, l_run = 0.0f;
  float acc[16][4];
#pragma unroll
  for (int jn = 0; jn < 16; ++jn)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[jn][k] = 0.0f;
  const uint4* qf_lane = qf + lane;
  float* s_row = s_sm + (real ? g : 0) * bk;

  int s = 0, phase = 0;
  auto next_stage = [&]() {
    __syncwarp();
    if (lane == 0) vzt::mbar_arrive(empty(s));
    if (warp == 0 && pb < end) {
      // Refill the slot once every warp has freed it.
      vzt::mbar_wait(empty(s), phase);
      issue(s);
    }
    if (++s == ST) {
      s = 0;
      phase ^= 1;
    }
  };

  for (int blk = first; blk < end; ++blk) {
    const int a = max(blk * bk, lo), e = min((blk + 1) * bk, hi);
    const int blk0 = blk * bk;
    const int pa = a / ps, pe = (e - 1) / ps;

    // K: the block's scores, in base 2, to shared memory; the warp's maximum.
    float mx = kNegInf;
    for (int pg = pa; pg <= pe; ++pg) {
      const int pn = min(ps, e - pg * ps);
      for (int c0 = 0; c0 < pn; c0 += kKeys) {
        vzt::mbar_wait_spin(full(s), phase);
        const int n_tok = min(kKeys, pn - c0);
        if (key0 < n_tok) {
          const uint8_t* st = smem + s * kDataBytes;
          float sc[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int k = 0; k < 4; ++k) sc[nt][k] = 0.0f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            // Two 16-byte loads a key row: chunks 2t and 2t + 1 (K3's layout).
            uint32_t kw[8];
            const int kr = key0 + 8 * nt + g;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const uint4 x = lds128(st + swz(kr, 2 * t + hh));
              kw[4 * hh] = x.x;
              kw[4 * hh + 1] = x.y;
              kw[4 * hh + 2] = x.z;
              kw[4 * hh + 3] = x.w;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint4 qa = qf_lane[j * 32];
              vzt::mma_m16n8k16_bf16(sc[nt], qa.x, qa.y, qa.z, qa.w, bf16x2_of_s8_even(kw[j]),
                                     bf16x2_of_s8_even(kw[j] >> 8));
            }
          }
          const float* ksc = scl + s * kKeys;
          const int pos0 = pg * ps + c0;  // the stage's first key
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int key = key0 + 8 * nt + 2 * t + e2;
              const int pos = pos0 + key;
              if (key < n_tok) {
                const float v = pos >= a ? sc[nt][e2] * (scale2 * (ksc[key] * kInvQuantMax))
                                         : kNegInf;
                mx = fmaxf(mx, v);
                if (real) s_row[pos - blk0] = v;
              }
            }
        }
        next_stage();
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    if (t == 0 && real) wmax[warp * kRows + g] = mx;
    __syncthreads();  // the block's scores and maxima are in

    // The online-softmax step, the same in every warp for its rows.
    float alpha = 1.0f;
    if (real) {
      const float m_next = fmaxf(m_run, fmaxf(fmaxf(wmax[g], wmax[kRows + g]),
                                              fmaxf(wmax[2 * kRows + g], wmax[3 * kRows + g])));
      alpha = vzt::ex2(m_run - m_next);
      m_run = m_next;
    }
    l_run *= alpha;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      acc[jn][0] *= alpha;
      acc[jn][1] *= alpha;
    }

    // V: the probabilities times the V scales, rounded to bf16, as P.V's A
    // fragments; O += P . V over the warp's two k-steps of 16 keys.
    for (int pg = pa; pg <= pe; ++pg) {
      const int pn = min(ps, e - pg * ps);
      for (int c0 = 0; c0 < pn; c0 += kKeys) {
        vzt::mbar_wait_spin(full(s), phase);
        const int n_tok = min(kKeys, pn - c0);
        if (key0 < n_tok) {
          const uint8_t* vreg = smem + s * kDataBytes;
          const float* vsc = scl + s * kKeys;
          const int pos0 = pg * ps + c0;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int r0 = key0 + 16 * ks + 2 * t;
            const int vr[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
            float pv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int pos = pos0 + vr[u];
              const bool ok = real && vr[u] < n_tok && pos >= a;
              const float pe_x = ok ? vzt::ex2(s_row[pos - blk0] - m_run) : 0.0f;
              l_run += pe_x;
              pv[u] = ok ? pe_x * (vsc[vr[u]] * kInvQuantMax) : 0.0f;
            }
            const uint32_t a0 = vzt::pack_bf16x2(pv[0], pv[1]);
            const uint32_t a2 = vzt::pack_bf16x2(pv[2], pv[3]);
            // Byte jn of each row's chunk g is n-tile jn (K3's int8 P.V).
            uint4 w[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) w[u] = lds128(vreg + swz(vr[u], g));
            const uint32_t wa[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
            const uint32_t wb[4] = {w[1].x, w[1].y, w[1].z, w[1].w};
            const uint32_t wc[4] = {w[2].x, w[2].y, w[2].z, w[2].w};
            const uint32_t wd[4] = {w[3].x, w[3].y, w[3].z, w[3].w};
#pragma unroll
            for (int qw = 0; qw < 4; ++qw) {
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
                vzt::mma_m16n8k16_bf16(acc[4 * qw + u], a0, 0u, a2, 0u, bb[u][0], bb[u][1]);
            }
          }
        }
        next_stage();
      }
    }
    __syncthreads();  // the scores and maxima are rewritten by the next block
  }

  // The warps' partials into shared memory (over the drained ring), then
  // thread tid owns column d = tid of every row.
  l_run += __shfl_xor_sync(kFullMask, l_run, 1);
  l_run += __shfl_xor_sync(kFullMask, l_run, 2);
  float* o_s = reinterpret_cast<float*>(smem);  // [kWarps][kRows][kOStride]
  if (real) {
    if (t == 0) lsum[warp * kRows + g] = l_run;
    if (warp == 0 && t == 0) mrow[g] = m_run;
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int dd = 16 * (2 * t + e2) + jn;  // K3's `Front<int8_t>::v_col`
        o_s[(warp * kRows + g) * kOStride + dd + (dd >> 5)] = acc[jn][e2];
      }
  }
  __syncthreads();
  const int d = tid;
  auto block_sum = [&](int r, float& M, float& L, float& O) {
    O = (o_s[(0 * kRows + r) * kOStride + d + (d >> 5)] +
         o_s[(1 * kRows + r) * kOStride + d + (d >> 5)]) +
        (o_s[(2 * kRows + r) * kOStride + d + (d >> 5)] +
         o_s[(3 * kRows + r) * kOStride + d + (d >> 5)]);
    L = (lsum[r] + lsum[kRows + r]) + (lsum[2 * kRows + r] + lsum[3 * kRows + r]);
    M = mrow[r];
    if (L == 0.0f) O = 0.0f;  // no key: nothing to scale (M is -inf)
  };
  // The self-term last, in f32, then out = O / l (0 where l = 0).
  auto finish = [&](int r, float M, float l, float o) {
    const float ss = self_s[kWarps * kRows + r];
    const float m_next = fmaxf(M, ss);
    const float al = vzt::ex2(M - m_next);
    const float p_self = vzt::ex2(ss - m_next);
    l = al * l + p_self;
    o = o * al + p_self * vn;
    const float l_inv = l == 0.0f ? 0.0f : 1.0f / l;
    p.out[q_base + r * kHeadDim + d] = __float2bfloat16_rn(o * l_inv);
  };

  if (p.splits == 1) {
    for (int r = 0; r < G; ++r) {
      float M, L, O;
      block_sum(r, M, L, O);
      finish(r, M, L, O);
    }
    return;
  }
  // This split's partial to scratch; the unit's last block merges them all
  // in split order.
  const long mine_row = (static_cast<long>(unit) * p.splits + split) * kRows;
  for (int r = 0; r < G; ++r) {
    float M, L, O;
    block_sum(r, M, L, O);
    __stcg(p.ws_o + (mine_row + r) * kHeadDim + d, O);
    if (d == 0) __stcg(reinterpret_cast<float2*>(p.ws_ml) + mine_row + r, make_float2(M, L));
  }
  __threadfence();
  __syncthreads();
  int* flag_s = reinterpret_cast<int*>(fixed + kFlag);
  if (tid == 0) *flag_s = atomicAdd(p.counters + unit, 1) == p.splits - 1;
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  // Every split's (m, l), then each row's M, L and the splits' weights (0 for
  // a split without a key), then each column's sum in split order.
  const long all = static_cast<long>(unit) * p.splits * kRows;
  float2* sml = reinterpret_cast<float2*>(fixed + kSml);  // [splits][kRows]
  float* sw = reinterpret_cast<float*>(fixed + kSw);      // [splits][kRows]
  for (int k = tid; k < p.splits * kRows; k += kThreads)
    sml[k] = __ldcg(reinterpret_cast<const float2*>(p.ws_ml) + all + k);
  __syncthreads();
  if (tid < G) {
    float M = -INFINITY, Ls = 0.0f;
    for (int sp = 0; sp < p.splits; ++sp)
      if (sml[sp * kRows + tid].y > 0.0f) M = fmaxf(M, sml[sp * kRows + tid].x);
    for (int sp = 0; sp < p.splits; ++sp) {
      const float2 x = sml[sp * kRows + tid];
      const float f = x.y > 0.0f ? vzt::ex2(x.x - M) : 0.0f;
      Ls += x.y * f;
      sw[sp * kRows + tid] = f;
    }
    mrow[tid] = M;
    lsum[tid] = Ls;
  }
  __syncthreads();
  for (int r = 0; r < G; ++r) {
    const float* o = p.ws_o + (all + r) * kHeadDim + d;
    float Os = 0.0f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float f = sw[sp * kRows + r];
      if (f > 0.0f) Os += __ldcg(o + static_cast<long>(sp) * kRows * kHeadDim) * f;
    }
    finish(r, mrow[r], lsum[r], Os);
  }
  if (tid == 0) p.counters[unit] = 0;
}

}  // namespace

// K11: q, out [B, Hq, D] bf16 (S = 1); pool [N, Hkv, 2 * ps, D] int8
// (KV-fused); scales [N, Hkv, 2 * ps] f32; page_table [B, pps], lengths,
// q_offs [B] int32; k_new, v_new [B, Hkv, D] bf16. Head dim 128, Hq / Hkv <=
// 4, ps % 4 == 0; window 0: none. `pair` (>= 2) slots a group, the last
// group may be short; `splits` is the wrapper's `paired_plan`: with splits >
// 1, ws_o is f32 [B * Hkv, splits, 4, 128], ws_ml f32 [B * Hkv, splits, 4,
// 2] and counters int32 [B * Hkv], zero (left zero).
extern "C" int vzt_paged_attn_paired(const void* q, void* out, const void* pool,
                                     const void* scales, const void* page_table,
                                     const void* lengths, const void* q_offs, const void* k_new,
                                     const void* v_new, void* ws_o, void* ws_ml, void* counters,
                                     int B, int Hq, int Hkv, int N, int ps, int pps,
                                     int pages_per_block, int page_offset, int window, int pair,
                                     int splits, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > kRows || ps <= 0 || ps % 4 || pps <= 0 ||
      pages_per_block <= 0 || pair < 2 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (ws_o == nullptr || ws_ml == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.scales = static_cast<const float*>(scales);
  p.page_table = static_cast<const int32_t*>(page_table);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.q_offs = static_cast<const int32_t*>(q_offs);
  p.k_new = static_cast<const __nv_bfloat16*>(k_new);
  p.v_new = static_cast<const __nv_bfloat16*>(v_new);
  p.ws_o = static_cast<float*>(ws_o);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.counters = static_cast<int*>(counters);
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
  p.splits = splits;
  p.scale = scale;
  p.stages = kMaxStages;
  size_t smem = smem_bytes(p.bk, p.stages);
  if (smem > kMaxSmem) smem = smem_bytes(p.bk, p.stages = 2);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);

  const long total_rows = static_cast<long>(N) * Hkv * 2 * ps;
  if (total_rows > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  const int code = vzt::make_map_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, pool,
                                    static_cast<int>(total_rows), kHeadDim, kHeadDim, 128,
                                    kBoxRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(paged_attn_paired_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long blocks = static_cast<long>((B + pair - 1) / pair) * pair * Hkv * splits;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  paged_attn_paired_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(tm, p);
  return static_cast<int>(cudaGetLastError());
}
