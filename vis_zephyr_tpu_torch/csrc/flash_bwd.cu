// K7 flash_bwd_dkv and K8 flash_bwd_dq: the flash attention backward pass
// (bf16 in and out) on Hopper's wgmma tensor cores, its tiles brought by TMA
// into rings in shared memory, recomputed from K1's softmax residuals.
//
// Replace the TPU kernels `vis_zephyr_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel` (K7) and `::_bwd_dq_kernel` (K8), whose grids
// `_flash_backward` builds. Same contract, on the port's public layout read
// in place by tensor maps seen as (column, head, row, batch), as K1 reads
// it: q and dO [B,T,Hq,D], k and v [B,S,Hkv,D] bf16, D = 128, T and S
// multiples of 64; kv_valid [B,S] bool; K1's per-row residuals m (natural-log
// units) and l and di = rowsum(o.dO), f32 [B,Hq,T]. Causal masking on row
// indices (col <= row) with the tiles wholly above the diagonal skipped; GQA
// (q head h reads kv head h / (Hq/Hkv)). The probabilities are recomputed as
// p = exp2(s*scale*log2(e) - (m*log2(e) + log2(l))) on a valid pair, 0
// elsewhere and on a row with l = 0 (K1 leaves l = 0 on a row without a
// valid key), which is exp(s*scale - m) / l; ds = p * (dp - di) * scale with
// dp = dO.v. So a row with no valid key gives dQ = 0 and an invalid key
// dK = dV = 0, exactly. Every product accumulates in f32 and the outputs
// are rounded to bf16 once.
//
// Departure from the TPU kernels, which multiply f32 p and ds: the tensor
// cores take bf16 operands, so p is rounded to bf16, and p * (dp - di),
// computed from that rounded p, is rounded to bf16 before the dV, dK and dQ
// products, as K1 rounds P before P.V (scale is applied to dK and dQ once,
// in the epilogue). The plain versions keep the f32 arithmetic;
// `chip_smoke.py` holds the kernels to them, and
// `tests/test_torch_flash_bwd.py` holds a copy of this rounding to the JAX
// backward at the same gates.
//
// What bounds them on the H100: operations. A causal T=S=2048 call at
// Hq=32 is 68.7 GFLOP for K7 (four products: S, dP, dV, dK) and 51.5 for K8
// (S, dP, dQ) against 42 MB and 50 MB, over 1000 FLOP a byte, far above the
// card's 295 (bf16). The bf16 rate comes only from wgmma, so every product
// runs there, its operands fed by TMA without register traffic.
//
// What the design does about it:
// - K7: one block per (128-key tile, kv head, batch row), two warpgroups of
//   64 keys each, so the keys are the M dimension and nothing is
//   transposed. K and V are loaded once (2 x 32 KB). The GQA group's q
//   heads' 64-row (Q, dO) tiles, under `causal` only those at or below the
//   diagonal, stream through a three-stage ring (32 KB a stage) with the
//   rows' m, l and di beside each stage (bulk copies); thread 0 issues
//   every copy and refills a stage once both warpgroups have freed it.
//   Per tile a warpgroup computes S^T = K.Q^T (wgmma m64n64k16, both
//   operands K-major in shared memory) and P^T in registers, in base 2
//   from each row's bias m*log2(e) + log2(l), masked only on the diagonal
//   tile and where its own keys hold an invalid one; then dV += P^T.dO
//   (m64n128k16, A from registers, where the accumulator fragment of S^T is
//   already the A fragment; dO the MN-major B operand) together with
//   dP^T = V.dO^T; then dS^T = P^T(dP^T - di) and dK += dS^T.Q, which runs
//   on while the next tile's S^T is issued. In these three rounds at most
//   one 32-float fragment waits beside dK and dV (128 floats), but ptxas
//   still takes about 226 registers a thread: more than a block of 384
//   threads may hold (168), and ptxas did not hand the consumers the
//   registers that setmaxnreg would move to them from a producer
//   warpgroup, so K1's schedule spilled and serialized the wgmmas here
//   (PERF.md). K7 therefore runs 256 threads and no producer warpgroup:
//   thread 0 issues the copies. dK and dV sum the whole GQA group in f32
//   registers and are written once, [B,S,Hkv,D], where the TPU kernel
//   writes per-q-head buffers summed afterwards (its grid cells cannot
//   share an accumulator). Blocks launch longest-first (key tile 0 has the
//   most q tiles under `causal`); a key tile without a valid key writes
//   zeros and returns.
// - K7 on a grid of fewer 128-key blocks than the card has SMs (B=1 at
//   T=2048: 128 blocks, the longest 16 times the shortest under `causal`)
//   takes 64-key blocks instead (kSplit): both warpgroups hold the same 64
//   keys and take alternate q tiles, each refilling the stages it frees,
//   and add their dK and dV through shared memory at the end. That halves
//   the longest block and doubles the blocks; on a full grid it would only
//   load each (Q, dO) tile twice as often.
// - K8: K1's schedule (`csrc/flash_fwd.cu`): 384 threads, two consumer
//   warpgroups of 64 q rows and a producer warpgroup that hands them its
//   registers (setmaxnreg 24 and 240; K8 fits in 168 anyway), the role
//   read from lane 0 so that the compiler sees it uniform across a warp.
//   One block per (128-row q tile, q head, batch row), as K1. Q and dO are
//   loaded once (2 x 32 KB); each row's bias and di live in registers. The
//   producer streams 64-key (K, V) tiles up to the diagonal through a
//   three-stage ring, with each tile's kv_valid as two ballot words beside
//   it; a tile without a valid key is not loaded and its stage is only
//   marked. Per tile: S = Q.K^T and dP = dO.V^T (m64n64k16), P and dS in
//   registers, dQ += dS.K (m64n128k16, the K tile as the MN-major B
//   operand). Longest q tiles first.
// - Epilogue: the f32 accumulators (dK times scale) rounded to bf16 into
//   the warpgroup's own rows of the K, V (K7) or Q (K8) tile, swizzled as
//   TMA reads them, then one TMA store per 64-column half.
// - A last tile of 64 rows (T or S a multiple of 64, not 128) leaves the
//   second warpgroup without rows: it returns at once and the ring's
//   "empty" barriers count only the active warpgroups' threads.
//
// Why two kernels and not one with dQ by atomics: K8 keeps its contract, no
// f32 dQ buffer is needed and gradients stay bit-reproducible.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kHalf64 = 64 * 128;               // bytes of a 64-row, 64-column half tile
constexpr int kHalf128 = 128 * 128;             // a 128-row half tile
constexpr int kStages = 3;                      // ring depth
static_assert(kStages >= 3,
              "K7 under kSplit frees a q tile's stage only at its warpgroup's next tile");
constexpr int kConsumers = 256;                 // K8: two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;      // + the producer warpgroup
constexpr int kStageBytes = 4 * kHalf64;        // two 64-row tiles of D = 128
constexpr float kLog2e = 1.44269504088896341f;

// K7: two warpgroups and no producer warpgroup (see the note above). Its
// shared memory: K and V (128 keys each), the (Q, dO) ring, the rows' m, l
// and di (3 x 64 floats a stage), the barriers.
constexpr int kDkvThreads = 256;
constexpr int kDkvRowBytes = 3 * 64 * 4;
constexpr int kDkvK = 0;
constexpr int kDkvV = 2 * kHalf128;
constexpr int kDkvRing = 4 * kHalf128;
constexpr int kDkvRows = kDkvRing + kStages * kStageBytes;
constexpr int kDkvBar = kDkvRows + kStages * kDkvRowBytes;   // kv_full, full[s], empty[s]
constexpr int kDkvSmem = kDkvBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack

// K8's: Q and dO (128 rows each), the (K, V) ring, two ballot words a stage,
// the barriers.
constexpr int kDqQ = 0;
constexpr int kDqDo = 2 * kHalf128;
constexpr int kDqRing = 4 * kHalf128;
constexpr int kDqMask = kDqRing + kStages * kStageBytes;
constexpr int kDqBar = kDqMask + kStages * 8;           // q_full, full[s], empty[s]
constexpr int kDqSmem = kDqBar + 8 * (1 + 2 * kStages) + 1024;

// acc[64 x 64] = A[64 x 128] . B[64 x 128]^T over D: 8 steps of 16, 4 in each
// 64-column half, both operands K-major swizzled tiles whose halves are
// `a_half` and `b_half` bytes apart.
__device__ __forceinline__ void issue_nt(float (&acc)[32], uint32_t a, uint32_t a_half,
                                         uint32_t b, uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t koff = (kk % 4) * 32;   // bytes into the swizzled 128-byte row
    vzt::wgmma_m64n64k16_ss(acc, vzt::desc_sw128(a + (kk / 4) * a_half + koff, 16, 1024),
                            vzt::desc_sw128(b + (kk / 4) * b_half + koff, 16, 1024), kk > 0);
  }
}

// acc[64 x 128] += A[64 x 64] . B[64 x 128]: A the bf16 fragments in
// registers (step kk takes A's columns 16kk .. 16kk+15), B a 64-row tile as
// TMA writes it, the MN-major operand (its two 64-column halves kHalf64 apart).
__device__ __forceinline__ void issue_nn(float (&acc)[64], const uint32_t (&a)[4][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    vzt::wgmma_m64n128k16_rs_tb(acc, a[kk], vzt::desc_sw128(b + kk * 16 * 128, kHalf64, 1024),
                                1);
}

// A warpgroup's 64 x 128 f32 accumulator times `mul`, rounded to bf16 into
// the 64 rows at `dst` of a swizzled tile whose halves are `half` bytes apart.
__device__ __forceinline__ void store_acc(uint8_t* dst, uint32_t half, const float (&acc)[64],
                                          float mul, int warp, int lane) {
  const int quad = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + (lane >> 2) + 8 * i;
      const int chunk = (jj % 8) ^ (r % 8);
      *reinterpret_cast<uint32_t*>(dst + (jj / 8) * half + r * 128 + chunk * 16 + quad * 4) =
          vzt::pack_bf16x2(acc[4 * jj + 2 * i] * mul, acc[4 * jj + 2 * i + 1] * mul);
    }
  }
}

// The exponent bias of a q row in base 2: m*log2(e) + log2(l), +inf where
// l = 0 (then every p of the row is exactly 0).
__device__ __forceinline__ float row_bias(float m, float l) {
  return l == 0.f ? INFINITY : fmaf(m, kLog2e, __log2f(l));
}

template <bool kSplit>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const uint8_t* __restrict__ kv_valid,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ di_in,
                     uint16_t* __restrict__ dk,
                     uint16_t* __restrict__ dv,
                     int T, int S, int Hq, int Hkv, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  constexpr int kKeys = kSplit ? 64 : 128;          // keys a block
  constexpr uint32_t kKVHalf = kKeys * 128;         // a K or V half tile
  const int key0 = blockIdx.z * kKeys;              // longest causal key tiles first
  const int tid = threadIdx.x;
  const int n_keys = min(kKeys, S - key0);
  const uint8_t* valid_row = kv_valid + static_cast<long>(b) * S;

  // A key tile without a valid key: dK = dV = 0 and nothing to compute.
  if (!__syncthreads_or(tid < n_keys && valid_row[key0 + tid] != 0)) {
    for (int idx = tid; idx < n_keys * 16; idx += kDkvThreads) {
      const long off = ((static_cast<long>(b) * S + key0 + idx / 16) * Hkv + hk) * 128 +
                       (idx % 16) * 8;
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const uint32_t raw = vzt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;     // swizzled tiles need 1024-byte alignment
  const uint32_t k_s = base + kDkvK;
  const uint32_t v_s = base + kDkvV;
  const uint32_t ring = base + kDkvRing;
  const float* rows_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + kDkvRows);
  const uint32_t kv_full = base + kDkvBar;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + kStages + s); };

  const int group = Hq / Hkv;
  const int n_active = kSplit ? 2 : min(2, n_keys / 64);   // warpgroups with work
  const int q_first = causal ? key0 / 64 : 0;        // the first q tile at or below the diagonal
  const int n_per = max(0, T / 64 - q_first);        // q tiles a q head
  const int n_iter = group * n_per;

  if (tid == 0) {
    vzt::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      vzt::mbar_init(full(s), 1);
      vzt::mbar_init(empty(s), kSplit ? 128 : 128 * n_active);   // the stage's consumers
    }
    vzt::fence_barrier_init();
  }
  __syncthreads();

  // Thread 0 issues every copy: q tile `it` (head it / n_per) into stage
  // it % kStages, Q and dO by TMA and the rows' m, l and di by bulk copies.
  auto issue = [&](int it) {
    const int s = it % kStages;
    const int h = hk * group + it / n_per;
    const int q0 = (q_first + it % n_per) * 64;
    const uint32_t qd = ring + s * kStageBytes;
    const uint32_t rows = base + kDkvRows + s * kDkvRowBytes;
    const long r = (static_cast<long>(b) * Hq + h) * T + q0;
    vzt::mbar_expect_tx(full(s), kStageBytes + kDkvRowBytes);
    vzt::tma_load_4d(qd, &tm_q, full(s), 0, h, q0, b);
    vzt::tma_load_4d(qd + kHalf64, &tm_q, full(s), 64, h, q0, b);
    vzt::tma_load_4d(qd + 2 * kHalf64, &tm_do, full(s), 0, h, q0, b);
    vzt::tma_load_4d(qd + 3 * kHalf64, &tm_do, full(s), 64, h, q0, b);
    vzt::bulk_load(rows, m_in + r, 64 * 4, full(s));
    vzt::bulk_load(rows + 64 * 4, l_in + r, 64 * 4, full(s));
    vzt::bulk_load(rows + 128 * 4, di_in + r, 64 * 4, full(s));
  };
  if (tid == 0) {
    vzt::mbar_expect_tx(kv_full, 4 * kKVHalf);
    vzt::tma_load_4d(k_s, &tm_k, kv_full, 0, hk, key0, b);
    vzt::tma_load_4d(k_s + kKVHalf, &tm_k, kv_full, 64, hk, key0, b);
    vzt::tma_load_4d(v_s, &tm_v, kv_full, 0, hk, key0, b);
    vzt::tma_load_4d(v_s + kKVHalf, &tm_v, kv_full, 64, hk, key0, b);
    for (int it = 0; it < min(kStages, n_iter); ++it) issue(it);
  }
  __syncwarp();
  // Frees the stage of q tile j and refills it with tile j + kStages once
  // its consumers have freed it: thread 0 waits for both warpgroups, or,
  // under kSplit, each warpgroup's first thread for its own.
  auto release = [&](int j) {
    vzt::mbar_arrive(empty(j % kStages));
    if ((kSplit ? tid % 128 == 0 : tid == 0) && j + kStages < n_iter) {
      vzt::mbar_wait(empty(j % kStages), (j / kStages) & 1);
      issue(j + kStages);
    }
    __syncwarp();
  };

  // Warpgroup `wg`: keys wk0 .. wk0 + 63 of the tile (under kSplit both
  // warpgroups hold the block's 64 keys and take alternate q tiles); the
  // thread holds rows (keys) wk0 + rw and wk0 + rw + 8 of S^T, dP^T, dK, dV.
  const int wg = tid / 128;
  if (wg >= n_active) return;
  const int warp = (tid % 128) / 32;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int wk0 = kSplit ? key0 : key0 + 64 * wg;
  const int rw = 16 * warp + (lane >> 2);
  const bool key_ok[2] = {valid_row[wk0 + rw] != 0, valid_row[wk0 + rw + 8] != 0};
  const bool keys_ok = key_ok[0] && key_ok[1];
  const uint32_t k_wg = k_s + (kSplit ? 0 : wg * kHalf64);
  const uint32_t v_wg = v_s + (kSplit ? 0 : wg * kHalf64);
  const float scale_log2 = scale * kLog2e;

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];
  int held = -1;   // the q tile whose Q a dK product still reads

  // A tile in three rounds of products, so that at most one 32-float
  // fragment beside dK and dV waits in registers: S^T; then dV += P^T dO
  // with dP^T = V dO^T; then dK += dS^T Q, which runs on while the next
  // tile's S^T is issued. dS^T is computed from the bf16 P^T that dV used.
  vzt::mbar_wait(kv_full, 0);
  for (int it = kSplit ? wg : 0; it < n_iter; it += kSplit ? 2 : 1) {
    const int s = it % kStages;
    const int q0 = (q_first + it % n_per) * 64;
    vzt::mbar_wait(full(s), (it / kStages) & 1);
    if (causal && q0 < wk0) {   // every key of the warpgroup is after every row
      if (held >= 0) {
        vzt::wgmma_wait<0>();
        vzt::fence_regs(dk_acc);
        release(held);
        held = -1;
      }
      release(it);
      continue;
    }
    const bool mask = !keys_ok || (causal && q0 < wk0 + 64);
    const uint32_t qd = ring + s * kStageBytes;
    const uint32_t dod = qd + 2 * kHalf64;
    const float* rows = rows_s + s * (kDkvRowBytes / 4);   // m, l, di of the 64 q rows

    vzt::wgmma_fence();
    issue_nt(sc, k_wg, kKVHalf, qd, kHalf64);      // S^T = K Q^T
    vzt::wgmma_commit();
    vzt::wgmma_wait<0>();                           // and the last tile's dK
    vzt::fence_regs(sc);
    vzt::fence_regs(dk_acc);
    if (held >= 0) release(held);

    // P^T: column 8j + 2quad + c is q row q0 + 8j + 2quad + c.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 m = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * quad);
      const float2 l = *reinterpret_cast<const float2*>(rows + 64 + 8 * j + 2 * quad);
      const float bias[2] = {row_bias(m.x, l.x), row_bias(m.y, l.y)};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sc[4 * j + 2 * i + c] = vzt::ex2(fmaf(sc[4 * j + 2 * i + c], scale_log2, -bias[c]));
      }
    }
    if (mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = q0 + 8 * j + 2 * quad + c;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!(key_ok[i] && (!causal || wk0 + rw + 8 * i <= row))) sc[4 * j + 2 * i + c] = 0.f;
          }
        }
      }
    }
    // P^T rounded to bf16: elements 8kk + 2r and + 1 (key row rw + 8 (r % 2),
    // q columns 16kk + 8 (r / 2) + 2quad and + 1) are word r of step kk's A
    // fragment.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = vzt::pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }

    vzt::fence_regs(dv_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) vzt::fence_regs(pa[kk]);
    vzt::wgmma_fence();
    issue_nn(dv_acc, pa, dod);                      // dV += P^T dO
    issue_nt(dp, v_wg, kKVHalf, dod, kHalf64);      // dP^T = V dO^T
    vzt::wgmma_commit();
    vzt::wgmma_wait<0>();
    vzt::fence_regs(dv_acc);
    vzt::fence_regs(dp);

    // dS^T / scale = P^T (dP^T - di), P^T as rounded above, itself rounded
    // to bf16 into the same fragment layout.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kk + 2 * r;
        const float2 di = *reinterpret_cast<const float2*>(rows + 128 + 16 * kk + 8 * (r / 2) +
                                                           2 * quad);
        const float p0 = __uint_as_float(pa[kk][r] << 16);
        const float p1 = __uint_as_float(pa[kk][r] & 0xffff0000u);
        da[kk][r] = vzt::pack_bf16x2(p0 * (dp[e] - di.x), p1 * (dp[e + 1] - di.y));
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) vzt::fence_regs(da[kk]);
    vzt::wgmma_fence();
    issue_nn(dk_acc, da, qd);                       // dK += dS^T Q
    vzt::wgmma_commit();
    held = it;
  }
  vzt::wgmma_wait<0>();
  vzt::fence_regs(dk_acc);
  if (held >= 0) release(held);

  uint8_t* gen = smem_raw + (base - raw);
  if (kSplit) {
    // The two warpgroups' sums meet in the ring, free once both are done:
    // warpgroup 1 writes its dK and dV there, warpgroup 0 adds them in.
    float* red = reinterpret_cast<float*>(gen + kDkvRing);
    const int t = tid % 128;
    vzt::named_barrier(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        red[i * 128 + t] = dk_acc[i];
        red[(64 + i) * 128 + t] = dv_acc[i];
      }
    }
    vzt::named_barrier(1, 256);
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      dk_acc[i] += red[i * 128 + t];
      dv_acc[i] += red[(64 + i) * 128 + t];
    }
  }

  // Epilogue: dK * scale and dV into this warpgroup's rows of the K and V
  // tiles (only its own products read them), then TMA stores.
  store_acc(gen + kDkvK + (k_wg - k_s), kKVHalf, dk_acc, scale, warp, lane);
  store_acc(gen + kDkvV + (v_wg - v_s), kKVHalf, dv_acc, 1.f, warp, lane);
  vzt::fence_proxy_async();
  vzt::named_barrier(kSplit ? 2 : 1 + wg, 128);
  if (tid % 128 == 0) {
    vzt::tma_store_4d(&tm_dk, k_wg, 0, hk, wk0, b);
    vzt::tma_store_4d(&tm_dk, k_wg + kKVHalf, 64, hk, wk0, b);
    vzt::tma_store_4d(&tm_dv, v_wg, 0, hk, wk0, b);
    vzt::tma_store_4d(&tm_dv, v_wg + kKVHalf, 64, hk, wk0, b);
    vzt::tma_store_wait_read();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const uint8_t* __restrict__ kv_valid,
                    const float* __restrict__ m_in,
                    const float* __restrict__ l_in,
                    const float* __restrict__ di_in,
                    int T, int S, int Hq, int Hkv, int causal, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = vzt::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base + kDqQ;
  const uint32_t do_s = base + kDqDo;
  const uint32_t ring = base + kDqRing;
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + kDqMask);
  const uint32_t q_full = base + kDqBar;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * 128;   // longest causal tiles first
  const int hk = h / (Hq / Hkv);
  const int n_active = min(2, (T - row0) / 64);          // warpgroups with rows
  int n_tiles = S / 64;
  if (causal) n_tiles = min(n_tiles, (row0 + 64 * n_active - 1) / 64 + 1);
  const int tid = threadIdx.x;

  if (tid == 0) {
    vzt::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      vzt::mbar_init(full(s), 1);
      vzt::mbar_init(empty(s), 128 * n_active);
    }
    vzt::fence_barrier_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);   // uniform, as in K7
  if (wg == kConsumers / 128) {
    // Producer warpgroup: its first warp brings Q and dO once, then the K/V
    // ring, packing each tile's kv_valid into two ballot words; a tile
    // without a valid key is only marked (words 0), not loaded.
    vzt::setmaxnreg_dec<24>();
    if (tid >= kConsumers + 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      vzt::tma_prefetch(&tm_k);
      vzt::tma_prefetch(&tm_v);
      vzt::mbar_expect_tx(q_full, 4 * kHalf128);
      vzt::tma_load_4d(q_s, &tm_q, q_full, 0, h, row0, b);
      vzt::tma_load_4d(q_s + kHalf128, &tm_q, q_full, 64, h, row0, b);
      vzt::tma_load_4d(do_s, &tm_do, q_full, 0, h, row0, b);
      vzt::tma_load_4d(do_s + kHalf128, &tm_do, q_full, 64, h, row0, b);
    }
    const uint8_t* valid_row = kv_valid + static_cast<long>(b) * S;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int kv0 = j * 64;
      const uint32_t w0 = __ballot_sync(0xffffffffu, valid_row[kv0 + lane] != 0);
      const uint32_t w1 = __ballot_sync(0xffffffffu, valid_row[kv0 + 32 + lane] != 0);
      if (j >= kStages) vzt::mbar_wait(empty(s), ((j / kStages) - 1) & 1);
      if (lane == 0) {
        mask_s[2 * s] = w0;
        mask_s[2 * s + 1] = w1;
        if (w0 | w1) {
          const uint32_t kd = ring + s * kStageBytes;
          vzt::mbar_expect_tx(full(s), kStageBytes);
          vzt::tma_load_4d(kd, &tm_k, full(s), 0, hk, kv0, b);
          vzt::tma_load_4d(kd + kHalf64, &tm_k, full(s), 64, hk, kv0, b);
          vzt::tma_load_4d(kd + 2 * kHalf64, &tm_v, full(s), 0, hk, kv0, b);
          vzt::tma_load_4d(kd + 3 * kHalf64, &tm_v, full(s), 64, hk, kv0, b);
        } else {
          vzt::mbar_arrive(full(s));
        }
      }
      __syncwarp();
    }
    return;
  }

  // Consumer warpgroup `wg`: q rows wrow0 .. wrow0 + 63 of the tile; the
  // thread holds rows row_a and row_a + 8.
  vzt::setmaxnreg_inc<240>();
  if (wg >= n_active) return;
  const int warp = (tid % 128) / 32;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int wrow0 = row0 + 64 * wg;
  const int row_a = wrow0 + 16 * warp + (lane >> 2);
  const uint32_t q_wg = q_s + wg * kHalf64;
  const uint32_t do_wg = do_s + wg * kHalf64;
  const float scale_log2 = scale * kLog2e;
  float bias[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long r = (static_cast<long>(b) * Hq + h) * T + row_a + 8 * i;
    bias[i] = row_bias(m_in[r], l_in[r]);
    di[i] = di_in[r];
  }

  float dq_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];

  vzt::mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int kv0 = j * 64;
    vzt::mbar_wait(full(s), (j / kStages) & 1);
    const uint32_t words[2] = {mask_s[2 * s], mask_s[2 * s + 1]};
    if ((words[0] | words[1]) == 0 || (causal && kv0 > wrow0 + 63)) {
      vzt::mbar_arrive(empty(s));   // no valid key, or every key after every row
      continue;
    }
    const bool mask = (words[0] & words[1]) != 0xffffffffu || (causal && kv0 + 63 > wrow0);
    const uint32_t kd = ring + s * kStageBytes;
    const uint32_t vd = kd + 2 * kHalf64;

    // The products overwrite sc and dp; zeroing them first tells the
    // compiler that the last tile's values are dead, which keeps K8 within
    // 168 registers a thread.
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    vzt::wgmma_fence();
    issue_nt(sc, q_wg, kHalf128, kd, kHalf64);      // S = Q K^T
    vzt::wgmma_commit();
    issue_nt(dp, do_wg, kHalf128, vd, kHalf64);     // dP = dO V^T
    vzt::wgmma_commit();
    vzt::wgmma_wait<1>();
    vzt::fence_regs(sc);

    // P: column 8jj + 2quad + c is key kv0 + 8jj + 2quad + c.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sc[4 * jj + 2 * i + c] = vzt::ex2(fmaf(sc[4 * jj + 2 * i + c], scale_log2, -bias[i]));
      }
    }
    if (mask) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = kv0 + 8 * jj + 2 * quad + c;
          const bool valid = (words[jj / 4] >> (8 * (jj % 4) + 2 * quad + c)) & 1u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (!(valid && (!causal || col <= row_a + 8 * i))) sc[4 * jj + 2 * i + c] = 0.f;
          }
        }
      }
    }
    vzt::wgmma_wait<0>();
    vzt::fence_regs(dp);
    // dS / scale = P (dP - di) with P rounded to bf16 as K7 rounds it,
    // itself rounded to bf16 pair by pair into the A fragments (element
    // 8kk + 2r is row row_a + 8 (r % 2)).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kk + 2 * r;
        const uint32_t pw = vzt::pack_bf16x2(sc[e], sc[e + 1]);
        da[kk][r] = vzt::pack_bf16x2(__uint_as_float(pw << 16) * (dp[e] - di[r % 2]),
                                     __uint_as_float(pw & 0xffff0000u) * (dp[e + 1] - di[r % 2]));
      }
    }

    vzt::fence_regs(dq_acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) vzt::fence_regs(da[kk]);
    vzt::wgmma_fence();
    issue_nn(dq_acc, da, kd);                       // dQ += dS K
    vzt::wgmma_commit();
    vzt::wgmma_wait<0>();
    vzt::fence_regs(dq_acc);
    vzt::mbar_arrive(empty(s));
  }

  // Epilogue: dQ * scale into this warpgroup's rows of the Q tile, then TMA
  // stores.
  store_acc(smem_raw + (base - raw) + kDqQ + wg * kHalf64, kHalf128, dq_acc, scale, warp, lane);
  vzt::fence_proxy_async();
  vzt::named_barrier(1 + wg, 128);
  if (tid % 128 == 0) {
    vzt::tma_store_4d(&tm_dq, q_wg, 0, h, wrow0, b);
    vzt::tma_store_4d(&tm_dq, q_wg + kHalf128, 64, h, wrow0, b);
    vzt::tma_store_wait_read();
  }
}

}  // namespace

extern "C" int vzt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* kv_valid, const void* dout,
                                 const void* m, const void* l, const void* di,
                                 void* dk, void* dv, int B, int T, int S, int Hq,
                                 int Hkv, int causal, float scale, void* stream) {
  // A grid of 128-key blocks smaller than the card leaves SMs idle while its
  // longest blocks run: take 64-key blocks, each split over q tiles between
  // its two warpgroups, there.
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool split = static_cast<long>(Hkv) * B * ((S + 127) / 128) < sms;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  int code = vzt::make_map_bf16_bthd(&tm_q, q, B, T, Hq, 64);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_do, dout, B, T, Hq, 64);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_k, k, B, S, Hkv, split ? 64 : 128);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_v, v, B, S, Hkv, split ? 64 : 128);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_dk, dk, B, S, Hkv, 64);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_dv, dv, B, S, Hkv, 64);
  if (code != 0) return code;
  const auto kernel = split ? flash_bwd_dkv_kernel<true> : flash_bwd_dkv_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B, split ? S / 64 : (S + 127) / 128);
  kernel<<<grid, kDkvThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, static_cast<const uint8_t*>(kv_valid),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(di), static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv),
      T, S, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vzt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* kv_valid, const void* dout,
                                const void* m, const void* l, const void* di,
                                void* dq, int B, int T, int S, int Hq, int Hkv,
                                int causal, float scale, void* stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dq;
  int code = vzt::make_map_bf16_bthd(&tm_q, q, B, T, Hq, 128);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_do, dout, B, T, Hq, 128);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_k, k, B, S, Hkv, 64);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_v, v, B, S, Hkv, 64);
  if (code == 0) code = vzt::make_map_bf16_bthd(&tm_dq, dq, B, T, Hq, 64);
  if (code != 0) return code;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hq, B, (T + 127) / 128);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dq, static_cast<const uint8_t*>(kv_valid),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(di), T, S, Hq, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
